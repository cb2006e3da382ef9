"""`--processes N` and `--alive` in the port's host stages
(origami_tpu_torch/batch/core/processor.py): spawned workers write the
same artifacts as one process, their kernel launch counts add up in the
parent, a batched stage says that it runs in one process, and the
watchdog ends a stalled pool and names the stuck page, as the JAX
package's Watchdog does (tests/test_tools.py:343). CPU, the fixture pages
(chip_smoke's corpus helpers: the JAX inputs of each stage).
"""

import json
import threading
import time
import zipfile
from pathlib import Path

import pytest

import chip_smoke
from origami_tpu_torch.batch.core import processor as proc
from origami_tpu_torch.batch.detect import contours, order

COMMON = ["--device", "cpu", "--lock-strategy", "NONE", "--plain"]


class StallingContours(contours.ContoursProcessor):
    """A contours stage whose pages never end (a worker that hangs).
    Each page marks its entry, with the time, in the `marks` folder."""

    def process(self, p, input, output):
        marks = Path(self._options["marks"])
        (marks / Path(p).name).write_text(repr(time.time()))
        time.sleep(120)
        return {}


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _artifacts(corpus, name):
    out = {}
    for d in sorted(corpus.glob("*.out")):
        f = d / name
        out[d.name] = _zip_entries(f) if name.endswith(".zip") \
            else f.read_bytes()
        status = json.loads((d / "runtime.json").read_text())
        assert all(v["status"] == "COMPLETED" for k, v in status.items()
                   if isinstance(v, dict) and "status" in v), status
    return out


@pytest.mark.parametrize("stage,make,artifact", [
    ("contours", lambda d: chip_smoke.chain_corpus(d, True),
     "contours.0.zip"),
    ("order", chip_smoke.order_corpus, "order.json"),
])
def test_two_processes_write_the_single_process_artifacts(
        tmp_path, stage, make, artifact, capsys):
    module = {"contours": contours, "order": order}[stage]
    one, two = make(tmp_path / "one"), make(tmp_path / "two")
    module.main(COMMON + ["--processes", "1", str(one)])
    module.main(COMMON + ["--processes", "2", str(two)])
    got, want = _artifacts(two, artifact), _artifacts(one, artifact)
    assert len(want) == 2
    assert got == want
    printed = capsys.readouterr().out
    # both pages reported by the parent as the workers end them
    assert printed.count("[2/2]") == 2


def test_watchdog_ends_a_stalled_worker(tmp_path):
    corpus = chip_smoke.chain_corpus(tmp_path / "c", True)
    marks = tmp_path / "marks"
    marks.mkdir()
    stage = StallingContours(dict(device="cpu", lock_strategy="NONE",
                                  plain=True, processes=2, alive=24,
                                  marks=str(marks)))
    with pytest.raises(SystemExit) as e:
        stage.traverse(str(corpus))
    assert e.value.code == 1
    # both pages entered; the pool ended after --alive counted from the
    # later entry, well before the pages' 120 s
    entered = sorted(float(m.read_text()) for m in marks.iterdir())
    assert len(entered) == 2
    assert time.time() - entered[-1] < 60
    # two pages for two workers: a chunk of one page each, both stuck
    stuck = sorted(page for page, _pid, _age in stage.stuck)
    assert [p.rsplit("/", 1)[-1] for p in stuck] \
        == ["synth0000.png", "synth0001.png"]
    assert len({pid for _page, pid, _age in stage.stuck}) == 2
    assert not list(corpus.glob("*.out/contours.0.zip"))


def test_watchdog_reports_stuck_pages():
    """One check driven by hand, as tests/test_tools.py:343 drives the
    JAX Watchdog."""
    class FakePool:
        terminated = False

        def terminate(self):
            self.terminated = True

    class HB:
        value = time.time() - 100      # stalled long ago

    work = {1234: ("corpus/page9.png", time.time() - 90),
            1235: ("corpus/page2.png", time.time() - 1)}
    pool = FakePool()
    wd = proc.Watchdog(pool, timeout=60, heartbeat=HB(), work_set=work)
    wd._done = threading.Event()
    wd._report_stuck()
    assert [s[0] for s in wd.stuck] == ["corpus/page9.png"]
    assert wd.stuck[0][1] == 1234 and wd.stuck[0][2] > 60
    # the thread's own loop (a check each timeout / 4): the first strike
    # terminates the pool; it is stopped well before a second strike
    wd._timeout = 4
    wd.start()
    t0 = time.time()
    while not wd.cancelled and time.time() - t0 < 10:
        time.sleep(0.02)
    wd.set_done()
    wd.join(5)
    assert pool.terminated and wd.cancelled


def test_worker_launches_add_to_the_parent_counters():
    from origami_tpu_torch.ops import binarize, remap
    before = proc._launch_snapshot()
    remap.launches.add("dewarp_u8", 3)
    binarize.launches.add("sauvola_packed")
    delta = proc._launch_delta(before)
    assert delta["remap"] == {"dewarp_u8": 3}
    assert delta["binarize"] == {"sauvola_packed": 1}
    assert delta["grid"] == {} and delta["gather"] == {}
    proc._add_launches(delta)
    assert remap.launches["dewarp_u8"] == before["remap"]["dewarp_u8"] + 6
    remap.launches["dewarp_u8"] = before["remap"]["dewarp_u8"]
    binarize.launches["sauvola_packed"] = \
        before["binarize"]["sauvola_packed"]


def test_batched_stage_says_it_runs_in_one_process(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(order.ReadingOrderProcessor, "POOLED", False)
    corpus = chip_smoke.order_corpus(tmp_path / "c", stems=("synth0000",))
    order.main(COMMON + ["--processes", "3", str(corpus)])
    printed = capsys.readouterr().out
    assert "runs in one process (--processes 3 asked)" in printed
    assert (corpus / "synth0000.out" / "order.json").exists()


def test_help_texts():
    import argparse
    pooled, batched = argparse.ArgumentParser(), argparse.ArgumentParser()
    proc.Processor.add_arguments(pooled)
    proc.Processor.add_arguments(batched, pooled=False)

    def text(p):
        return next(a.help for a in p._actions if a.dest == "processes")
    assert text(pooled) == "Number of parallel worker processes."
    assert "batched stages run in one process" in text(batched)
