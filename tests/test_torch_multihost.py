"""The port's multi-process page assignment (origami_tpu_torch/parallel/
multihost.py) against the JAX package's: the same hash, the same pages
to each process, and two gloo processes of the port's segment stage that
process each page exactly once, on its hashed host (the port of
tests/test_multihost.py); a launch that is configured but cannot come up
raises, and a launch's card is the one its kernels run on.

Tolerance: none; the assignment is the same blake2s hash byte for byte.
"""

import os
import socket
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import PIL.Image
import pytest
import torch

from origami_tpu.parallel import multihost as jax_multihost
from origami_tpu_torch.device import resolve
from origami_tpu_torch.ops import remap
from origami_tpu_torch.parallel import multihost

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_ENV = ("ORIGAMI_TPU_COORDINATOR", "ORIGAMI_TPU_NUM_PROCESSES",
              "ORIGAMI_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
              "RANK", "WORLD_SIZE", "LOCAL_RANK")


def _paths():
    rng = np.random.default_rng(17)
    return [Path("/corpus/%s/page%05d.%s" % (
        rng.choice(["a", "bb", "c c"]), int(rng.integers(0, 10 ** 5)),
        rng.choice(["png", "jpg", "tif"]))) for _ in range(200)]


@pytest.mark.parametrize("count", range(1, 9))
def test_assignment_equals_jax(count):
    paths = _paths()
    assert [multihost.stable_shard(p, count) for p in paths] \
        == [jax_multihost.stable_shard(p, count) for p in paths]
    shards = [multihost.my_pages(paths, index=i, count=count)
              for i in range(count)]
    assert shards == [jax_multihost.my_pages(paths, index=i, count=count)
                      for i in range(count)]
    assert sorted(sum(shards, []), key=str) == sorted(paths, key=str)


@pytest.fixture
def no_launch(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_no_launch_is_single_process(no_launch):
    assert multihost.maybe_initialize() is False
    assert multihost.process_info() == (0, 1)
    assert multihost.local_index() is None
    assert multihost.my_pages(["a", "b"]) == ["a", "b"]


@pytest.mark.parametrize("env,index", [
    ({"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1",
      "ORIGAMI_TPU_NUM_PROCESSES": "2", "ORIGAMI_TPU_PROCESS_ID": "1"}, 1),
    ({"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1",
      "ORIGAMI_TPU_NUM_PROCESSES": "4", "ORIGAMI_TPU_PROCESS_ID": "3",
      "LOCAL_RANK": "0"}, 0),
    ({"MASTER_ADDR": "127.0.0.1", "WORLD_SIZE": "2", "RANK": "1"}, 1),
    ({"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1",
      "ORIGAMI_TPU_NUM_PROCESSES": "1", "ORIGAMI_TPU_PROCESS_ID": "0"},
     None),
    # no coordinator: no launch, as in the JAX package (no group comes up)
    ({"ORIGAMI_TPU_NUM_PROCESSES": "2", "ORIGAMI_TPU_PROCESS_ID": "1"},
     None),
])
def test_local_index_of_a_launch(no_launch, env, index):
    for k, v in env.items():
        no_launch.setenv(k, v)
    assert multihost.local_index() == index


def test_a_launch_makes_its_card_current(no_launch):
    """A bare "cuda" under a launch is card (local index % cards), and
    that card becomes the process's current device, so the kernels'
    launches (which take the current device's stream) land on it."""
    made_current = []
    no_launch.setattr(torch.cuda, "is_available", lambda: True)
    no_launch.setattr(torch.cuda, "device_count", lambda: 2)
    no_launch.setattr(torch.cuda, "set_device", made_current.append)
    for k, v in {"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1",
                 "ORIGAMI_TPU_NUM_PROCESSES": "4",
                 "ORIGAMI_TPU_PROCESS_ID": "3"}.items():
        no_launch.setenv(k, v)
    assert resolve() == resolve("cuda") == torch.device("cuda", 1)
    assert made_current == [torch.device("cuda", 1)] * 2
    # an explicit card wins and changes nothing
    assert resolve("cuda:0") == torch.device("cuda", 0)
    assert len(made_current) == 2


def test_a_kernel_launches_on_its_tensors_card(monkeypatch):
    """remap._launch makes the tensors' card current for the call and
    passes that card's stream, whatever card was current before."""
    current = [0]

    class Device:
        def __init__(self, index):
            self.index, self.prev = index, None

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current[0],
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 100 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Device)
    calls = []

    def entry(*args):
        calls.append((args, current[0]))
        return 0

    for index in (1, 0):
        remap._launch(torch.device("cuda", index), entry, 7)
    assert calls == [((7, 101), 1), ((7, 100), 0)]
    assert current == [0]


@pytest.mark.parametrize("env,match", [
    ({"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1"}, "number of processes"),
    ({"ORIGAMI_TPU_COORDINATOR": "127.0.0.1:1",
      "ORIGAMI_TPU_NUM_PROCESSES": "2", "ORIGAMI_TPU_PROCESS_ID": "2"},
     "not one of 2"),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2"},
     "RANK"),
])
def test_a_configured_launch_that_cannot_come_up_raises(no_launch, env,
                                                        match):
    """JAX declines quietly where a TPU plugin sets its markers; the
    port raises (ROADMAP C8). None of these reaches the network."""
    for k, v in env.items():
        no_launch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        multihost.maybe_initialize()
    assert multihost.process_info() == (0, 1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_a_launch_whose_group_fails_to_come_up_raises(no_launch):
    """A well-formed launch whose process group cannot come up (process
    0 cannot listen on the coordinator's port) raises instead of running
    as a single process."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        no_launch.setenv("ORIGAMI_TPU_COORDINATOR",
                         "127.0.0.1:%d" % taken.getsockname()[1])
        no_launch.setenv("ORIGAMI_TPU_NUM_PROCESSES", "2")
        no_launch.setenv("ORIGAMI_TPU_PROCESS_ID", "0")
        with pytest.raises(RuntimeError, match="address already in use"):
            multihost.maybe_initialize()
    finally:
        taken.close()
    assert multihost.process_info() == (0, 1)


def test_two_process_segment_stage_exactly_once(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(3)
    # 4 page names whose hash assignment covers both shards
    names, shard_of = [], {}
    i = 0
    while len(names) < 4:
        name = "page%03d.png" % i
        i += 1
        shard = multihost.stable_shard(corpus / name, 2)
        if len(names) == 3 and set(shard_of.values()) == {shard}:
            continue
        shard_of[name] = shard
        names.append(name)
    for name in names:
        img = np.full((160, 120), 230, np.uint8)
        img[40:44, 10:110] = 20
        img += rng.integers(0, 8, img.shape).astype(np.uint8)
        PIL.Image.fromarray(img).save(str(corpus / name))

    port = _free_port()
    procs = []
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    for pid in range(2):
        env = dict(base, PYTHONPATH=str(ROOT),
                   ORIGAMI_TPU_COORDINATOR="127.0.0.1:%d" % port,
                   ORIGAMI_TPU_NUM_PROCESSES="2",
                   ORIGAMI_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "origami_tpu_torch.batch.detect.segment",
             "-m", "heuristic", "--device", "cpu", "--plain",
             str(corpus)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)

    assigned = []
    for pid, (out, _) in enumerate(outs):
        lines = [line for line in out.splitlines()
                 if "pages assigned" in line]
        assert len(lines) == 1 and lines[0].startswith("host %d/2: " % pid)
        assigned.append(int(lines[0].split(": ")[1].split()[0]))
    assert min(assigned) > 0 and sum(assigned) == len(names)

    for name in names:
        seg = corpus / (Path(name).stem + ".out") / "segment.zip"
        with zipfile.ZipFile(seg) as zf:
            assert "regions.png" in zf.namelist()
    # each page once, by the host its hash names
    done = [(pid, Path(line.split()[-1]).name)
            for pid, (out, _) in enumerate(outs)
            for line in out.splitlines() if line.startswith("[")]
    assert sorted(n for _, n in done) == sorted(names)
    assert all(shard_of[n] == pid for pid, n in done)
