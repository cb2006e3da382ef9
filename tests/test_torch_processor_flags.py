"""The runtime flags of every port stage (batch/core/processor.py):
`--track-changes TAG` (TrackChangeWriter: writes only what changed and
leaves `.checked` / `.changed` markers), `--debug-write` (each write
printed with its size) and `--profile` (cProfile's 30 largest cumulative
entries printed, a torch.profiler Chrome trace under
`<corpus>/torch-trace/`, artifacts overwritten), on the order stage of
one fixture page on the CPU (chip_smoke.order_corpus: the JAX inputs).
The writers' behaviour is the JAX package's (origami_tpu/batch/core/
io.py:143-200), checked here on the same calls.
"""

import json
import zipfile
from pathlib import Path

import pytest

import chip_smoke
from origami_tpu.batch.core import io as jax_io
from origami_tpu_torch.batch.core import io
from origami_tpu_torch.batch.detect import order

COMMON = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]


@pytest.fixture
def corpus(tmp_path):
    return chip_smoke.order_corpus(tmp_path / "c", stems=("synth0000",))


def _run(corpus, *flags):
    order.main(COMMON + list(flags) + [str(corpus)])


def test_track_changes_marks_new_and_changed_artifacts(corpus, capsys):
    out = corpus / "synth0000.out"
    _run(corpus, "--track-changes", "run1")
    assert (out / "order.checked").read_text() == "run1"
    assert not (out / "order.changed").exists()
    first = (out / "order.json").read_bytes()
    # the same result again: nothing rewritten, no .changed marker
    _run(corpus, "--track-changes", "run2")
    assert (out / "order.json").read_bytes() == first
    assert not (out / "order.changed").exists()
    # a changed artifact is replaced and marked
    (out / "order.json").write_text(json.dumps({"orders": {}}))
    _run(corpus, "--track-changes", "run3")
    assert (out / "order.changed").read_text() == "run3"
    assert (out / "order.json").read_bytes() == first
    assert not list(out.glob("*.tmp"))
    capsys.readouterr()


@pytest.mark.parametrize("kind", ["json", "zip"])
def test_track_change_writer_is_jax_s(tmp_path, kind):
    """The same files and markers as the JAX writer for the same
    writes, zips compared by their members."""
    def body(tag, payload):
        def write(f):
            if kind == "zip":
                with zipfile.ZipFile(f, "w") as zf:
                    zf.writestr("a.txt", payload)
            else:
                f.write(payload.encode())
        return write

    seen = []
    for module in (io, jax_io):
        d = tmp_path / module.__name__
        d.mkdir()
        path = d / ("x." + kind)
        for tag, payload in (("t1", "one"), ("t2", "one"), ("t3", "two")):
            with module.TrackChangeWriter(tag)(path) as f:
                body(tag, payload)(f)
        seen.append(sorted((p.name, p.read_bytes() if p.suffix != ".zip"
                            else b"zip") for p in d.iterdir()))
    assert seen[0] == seen[1]


def test_debug_write_prints_each_write(corpus, capsys):
    _run(corpus, "--debug-write")
    out = capsys.readouterr().out
    path = corpus / "synth0000.out" / "order.json"
    assert "write: opening %s" % path in out
    assert "write: %s written, %d bytes" % (
        path, path.stat().st_size) in out


def test_profile_writes_stats_and_a_trace(corpus, capsys):
    _run(corpus)
    before = (corpus / "synth0000.out" / "order.json").stat().st_mtime_ns
    _run(corpus, "--profile")                     # overwrites
    out = capsys.readouterr().out
    assert "cumulative" in out and "function calls" in out
    assert (corpus / "synth0000.out" / "order.json").stat().st_mtime_ns \
        > before
    trace = corpus / "torch-trace" / (order.STAGE_NAME + ".json")
    assert json.loads(trace.read_text())["traceEvents"] is not None
