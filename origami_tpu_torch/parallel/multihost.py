"""Multi-host work assignment.

Port of origami_tpu/parallel/multihost.py. The reference coordinates
nodes through a SQLite lock database on a shared filesystem
(origami/batch/core/mutex.py). Here, as in the JAX package, the
assignment is deterministic instead: every process takes the pages whose
stable hash lands on its rank, with no lock traffic on the corpus path.
The lock database still guards the pages (batch.core.mutex), for fleets
that write one artifact tree from several launches.

The process group is torch.distributed on gloo. Serving sends no tensor
between processes, and two processes on one card is a launch that NCCL
does not allow.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import os

# a manual fleet: the same variables drive both packages' launches
_COORDINATOR = "ORIGAMI_TPU_COORDINATOR"
_NUM_PROCESSES = "ORIGAMI_TPU_NUM_PROCESSES"
_PROCESS_ID = "ORIGAMI_TPU_PROCESS_ID"
# jax.distributed.initialize's own default
_INIT_TIMEOUT = datetime.timedelta(seconds=300)


def _launch_config(coordinator_address=None, num_processes=None,
                   process_id=None):
    """The multi-process launch that the arguments and the environment
    describe -> (init_method, number of processes, this process's id),
    or None outside one.

    Explicit arguments win; otherwise a manual fleet is recognized by
    ORIGAMI_TPU_COORDINATOR (host:port of process 0) with
    ORIGAMI_TPU_NUM_PROCESSES and ORIGAMI_TPU_PROCESS_ID, and a managed
    launch by torchrun's MASTER_ADDR and WORLD_SIZE (with RANK and
    MASTER_PORT), where the JAX package looks for a TPU pod's markers.
    Raises ValueError where a launch is named but incomplete."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(_COORDINATOR)
    if num_processes is None and env.get(_NUM_PROCESSES):
        num_processes = int(env[_NUM_PROCESSES])
    if process_id is None and env.get(_PROCESS_ID):
        process_id = int(env[_PROCESS_ID])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                "a launch through %s needs the number of processes and "
                "this process's id (%s, %s)" % (
                    coordinator_address, _NUM_PROCESSES, _PROCESS_ID))
        init_method = coordinator_address \
            if "://" in coordinator_address \
            else "tcp://" + coordinator_address
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        if "RANK" not in env:
            raise ValueError("a launch through MASTER_ADDR needs RANK")
        init_method = "env://"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return None
    if not 0 <= process_id < num_processes:
        raise ValueError("process id %d is not one of %d processes"
                         % (process_id, num_processes))
    return init_method, num_processes, process_id


def maybe_initialize(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Bring up the gloo process group under a multi-process launch
    (_launch_config says which); without one it is a no-op. A launch
    that is configured but cannot come up raises (the JAX package
    declines quietly where a TPU plugin sets its markers). Returns True
    iff the group is up with more than one process.

    Processor.traverse calls it first thing."""
    import torch.distributed as dist
    if not dist.is_initialized():
        config = _launch_config(coordinator_address, num_processes,
                                process_id)
        if config is None:
            return False
        init_method, num_processes, process_id = config
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=num_processes,
            rank=process_id, timeout=_INIT_TIMEOUT)
        logging.info("torch.distributed up: process %d/%d",
                     dist.get_rank(), dist.get_world_size())
    return dist.get_world_size() > 1


def process_info():
    """(this process's rank, the number of processes); (0, 1) without a
    process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_index():
    """This process's index on its host under a multi-process launch
    (LOCAL_RANK, else its process id), None outside one: the process
    group's answer, or before the group is up, the launch's.
    device.resolve makes that card the process's own."""
    index, count = process_info()
    if count == 1:
        config = _launch_config()
        if config is None:
            return None
        _, count, index = config
    if count <= 1:
        return None
    return int(os.environ.get("LOCAL_RANK", index))


def stable_shard(path, n_shards):
    """Deterministic shard id for a page path."""
    h = hashlib.blake2s(str(path).encode("utf8"), digest_size=8)
    return int.from_bytes(h.digest(), "little") % max(n_shards, 1)


def my_pages(paths, index=None, count=None):
    """The subset of corpus pages this process is responsible for."""
    if index is None or count is None:
        index, count = process_info()
    if count <= 1:
        return list(paths)
    return [p for p in paths if stable_shard(p, count) == index]
