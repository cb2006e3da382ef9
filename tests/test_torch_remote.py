"""The port's remote runner (origami_tpu_torch/batch/remote) on the CPU
(`--device cpu`), through ssh/scp shims at the front of PATH that run
the commands here (chip_smoke.SSH_SHIM, SCP_SHIM).

Bars:
  * `remote -m heuristic` pushes back a segment.zip whose label maps, and
    contours.*.zip whose members, equal a direct run of the port's
    segment and contours stages on the same page; the task DB says DONE
    and a second run processes no page (chip_smoke phase 20c);
  * pages marked DONE are skipped, a failing scp marks the page FAILED
    and the run goes on with the next;
  * the task DB has the JAX runner's schema, and `signature` gives the
    JAX runner's string.
"""

import contextlib
import io
import shutil
import sqlite3

import pytest

import chip_smoke
from origami_tpu_torch.batch.remote import runner


def test_remote_run_equals_direct_run_and_resumes(tmp_path):
    launched, _ = chip_smoke.check_remote(tmp_path, "cpu")
    assert launched == {}


class _Stage:
    """Records the pages it is asked to traverse and writes an .out."""

    def __init__(self):
        self.pages = []

    def traverse(self, page):
        self.pages.append(page.name)
        out = page.with_suffix(".out")
        out.mkdir(exist_ok=True)
        (out / "seen.txt").write_text(page.name)


def _remote(tmp_path, names):
    remote = tmp_path / "remote"
    remote.mkdir()
    for name in names:
        shutil.copy(chip_smoke.FIXTURE / "synth0000.png", remote / name)
    (remote / "notes.txt").write_text("not a page")
    return remote


def test_resume_skips_done_pages(tmp_path):
    remote = _remote(tmp_path, ["a.png", "b.png", "c.jpg"])
    bin_dir = chip_smoke.write_shims(tmp_path / "bin")
    work = tmp_path / "work"
    work.mkdir()
    db = runner.TaskDB(work / "remote.tasks.db")
    db.mark("a.png", "DONE", "x")
    db.mark("b.png", "FAILED")
    stage = _Stage()
    with chip_smoke.with_path(bin_dir):
        corpus = runner.RemoteCorpus("host", str(remote) + "/")
        assert corpus.list_pages() == ["a.png", "b.png", "c.jpg"]
        n = runner.run_remote("host", str(remote), [stage], work)
    assert n == 2 and stage.pages == ["b.png", "c.jpg"]
    assert (remote / "b.out" / "seen.txt").read_text() == "b.png"
    assert not (remote / "a.out").exists()
    assert db.status("b.png") == db.status("c.jpg") == "DONE"
    sig = sqlite3.connect(str(work / "remote.tasks.db")).execute(
        "SELECT signature FROM tasks WHERE remote_path = 'c.jpg'"
    ).fetchone()[0]
    assert sig == runner.signature(work / "c.jpg")


def test_failing_scp_marks_failed(tmp_path):
    remote = _remote(tmp_path, ["a.png", "b.png"])
    bin_dir = chip_smoke.write_shims(tmp_path / "bin")
    # scp fails for b.png only
    (bin_dir / "scp").write_text(
        '#!/bin/sh\ncase "$*" in *b.png*) exit 1 ;; esac\n'
        + chip_smoke.SCP_SHIM.split("\n", 1)[1])
    work = tmp_path / "work"
    stage = _Stage()
    err = io.StringIO()
    with chip_smoke.with_path(bin_dir), contextlib.redirect_stderr(err):
        n = runner.run_remote("host", str(remote), [stage], work)
    db = runner.TaskDB(work / "remote.tasks.db")
    assert n == 1 and stage.pages == ["a.png"]
    assert db.status("a.png") == "DONE" and db.status("b.png") == "FAILED"
    assert "failed b.png" in err.getvalue()


def test_task_db_and_signature_equal_jax(tmp_path):
    from origami_tpu.batch.remote import runner as jax_runner
    jax_runner.TaskDB(tmp_path / "j.db").mark("p.png", "DONE", "s")
    runner.TaskDB(tmp_path / "p.db").mark("p.png", "DONE", "s")
    info = [sqlite3.connect(str(tmp_path / n)).execute(
        "PRAGMA table_info(tasks)").fetchall() for n in ("j.db", "p.db")]
    assert info[0] == info[1]
    assert jax_runner.TaskDB(tmp_path / "p.db").status("p.png") == "DONE"
    page = chip_smoke.FIXTURE / "synth0001.png"
    assert runner.signature(page) == jax_runner.signature(page)
    assert runner.file_digest(page) == jax_runner.file_digest(page)


def test_remote_cli_needs_cuda_unless_told_cpu(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--host", "h", "--remote-dir", str(tmp_path)])
    stages = runner.remote_stages("heuristic", "cpu")
    assert [s.device.type for s in stages] == ["cpu", "cpu"]
