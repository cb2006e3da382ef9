"""Batch runtime: corpus traversal, work queue, locks, runtime.json.

Port of origami_tpu/batch/core/processor.py for device-batched stages:
walk a corpus directory, queue the pages whose declared inputs exist and
whose outputs do not (:225-288), process them in page batches under the
lock strategy, record each page's status in runtime.json — a failure is
captured with its traceback and the batch loop keeps going.

Every processor carries a `torch.device` (the `device` option, "cuda"
unless the caller asks for "cpu"). Under a multi-process launch
(parallel.multihost) each process queues only its hashed share of the
pages (:371-390); the JAX runtime's compile cache has no counterpart.
The host stages (`POOLED`: contours, flow,
dewarp, layout, lines, order, compose) run in `--processes` spawned
workers under a `Watchdog` that `--alive` times (:40-147, :442-470);
each worker opens its own CUDA context, and the kernel launches it
counts are added to the parent's counters. The batched stages (segment,
OCR) run in one process, as the JAX package's do, and say so when asked
for more. `--profile` runs cProfile (the
30 largest cumulative entries printed at the end) and torch.profiler,
whose Chrome trace goes to `<corpus>/torch-trace/` (the JAX runtime's
`jax.profiler.trace` into `<corpus>/jax-trace`); `--track-changes TAG`
and `--debug-write` choose the file writer as the JAX runtime does
(:225-231).
"""

from __future__ import annotations

import json
import logging
import multiprocessing
import os
import re
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from origami_tpu_torch.batch.core import mutex as _mutex
from origami_tpu_torch.batch.core.io import (
    AtomicFileWriter, Artifact, DebuggingFileWriter, TrackChangeWriter,
    find_data_path)
from origami_tpu_torch.core.page import is_image
from origami_tpu_torch.device import resolve


class Watchdog(threading.Thread):
    """Terminates a stalled pool after `timeout` seconds without a
    completed page; a second strike hard-exits the process.

    `work_set` (a shared dict pid -> (page, since)) is the in-flight
    work the workers register: on a stall the watchdog names the pages
    stuck in each worker (`stuck`: [(page, pid, age)])."""

    def __init__(self, pool, timeout, heartbeat, work_set=None):
        super().__init__(daemon=True)
        self._pool = pool
        self._timeout = timeout
        self._heartbeat = heartbeat
        self._work_set = work_set
        self._done = threading.Event()
        self._cancelled = False
        self._strikes = 0
        self.stuck = []

    def _report_stuck(self):
        if self._work_set is None:
            return
        try:
            now = time.time()
            for pid, (page, since) in dict(self._work_set).items():
                age = now - since
                if age > self._timeout / 2:
                    self.stuck.append((page, pid, age))
                    logging.error("watchdog: worker %s stuck on %s for "
                                  "%.0fs", pid, page, age)
        except Exception:
            logging.exception("watchdog: cannot read the work set")

    def run(self):
        while not self._done.wait(min(self._timeout / 4, 15)):
            if time.time() - self._heartbeat.value > self._timeout:
                self._strikes += 1
                if self._strikes == 1:
                    logging.error("watchdog: no progress in %ds, "
                                  "terminating pool", self._timeout)
                    self._report_stuck()
                    self._cancelled = True
                    self._pool.terminate()
                else:
                    logging.error("watchdog: second strike, exiting")
                    os._exit(1)

    def set_done(self):
        self._done.set()

    @property
    def cancelled(self):
        return self._cancelled


def _chunks(items, n):
    for i in range(0, len(items), n):
        yield items[i:i + n]


def _launch_counters():
    """The kernel wrappers' launch counters, by module."""
    from origami_tpu_torch.ops import binarize, gather, grid, remap
    return {"remap": remap.launches, "binarize": binarize.launches,
            "gather": gather.launches, "grid": grid.launches}


def _launch_snapshot():
    return {m: dict(c) for m, c in _launch_counters().items()}


def _launch_delta(before):
    return {m: {k: v - before[m].get(k, 0) for k, v in c.items()
                if v != before[m].get(k, 0)}
            for m, c in _launch_counters().items()}


def _add_launches(delta):
    """Add a worker's launch counts to this process's counters."""
    counters = _launch_counters()
    for m, counts in delta.items():
        for k, n in counts.items():
            counters[m].add(k, n)


# worker globals (set per spawned worker by _worker_init)
_worker_self = None
_worker_heartbeat = None
_worker_work_set = None


def _worker_init(factory, factory_args, heartbeat, mutex, work_set=None):
    global _worker_self, _worker_heartbeat, _worker_work_set
    _worker_self = factory(*factory_args)
    _worker_self._mutex = mutex
    _worker_heartbeat = heartbeat
    _worker_work_set = work_set


def _worker_run_chunk(chunk):
    """chunk: [(index, path str)]. The worker rebuilds each page's
    readers and writers (prepare_process), so only paths cross the
    process boundary. Returns ([(index, path str)], the kernel launches
    the chunk made, by counter module). Taking up a chunk counts as
    progress, so --alive runs from a worker's first page and not from
    the pool's start: a worker's spawn (seconds under load) is no stall."""
    if _worker_heartbeat is not None:
        _worker_heartbeat.value = time.time()
    before = _launch_snapshot()
    results = []
    for i, path in _worker_self._run_chunk_paths(
            [(i, Path(p)) for i, p in chunk]):
        results.append((i, str(path)))
        if _worker_heartbeat is not None:
            _worker_heartbeat.value = time.time()
    if _worker_work_set is not None:
        _worker_work_set.pop(os.getpid(), None)
    return results, _launch_delta(before)


class Processor:
    def __init__(self, options=None):
        options = options or {}
        self._options = dict(options)
        self._overwrite = options.get("overwrite", False)
        self._name_filter = options.get("name", "")
        self._lock_strategy = str(options.get("lock_strategy", "DB")).upper()
        self._lock_level = str(options.get("lock_level", "PAGE")).upper()
        self._lock_timeout = options.get("lock_timeout", 60)
        self._max_lock_age = options.get("max_lock_age", 600)
        self._lock_database = options.get("lock_database")
        self._plain = options.get("plain", False)
        self._debug_write = options.get("debug_write", False)
        self._track_changes = options.get("track_changes", "")
        self._profile = options.get("profile", False)
        if self._profile:
            self._overwrite = True
        self._processes = int(options.get("processes", 1) or 1)
        self._timeout = options.get("alive", 600)
        self.device = resolve(options.get("device"))
        self._mutex = None

    # -- CLI ---------------------------------------------------------------
    @staticmethod
    def add_arguments(parser, pooled=True):
        """The JAX CLI's runtime options (names and defaults), plus
        --device. `pooled`: the stage runs --processes workers (the host
        stages); the batched stages run in one process."""
        parser.add_argument("--processes", type=int, default=1,
                            help="Number of parallel worker processes."
                            if pooled else
                            "Number of parallel worker processes "
                            "(batched stages run in one process).")
        parser.add_argument("--alive", type=int, default=600,
                            help="Watchdog timeout in seconds.")
        parser.add_argument("--name", type=str, default="",
                            help="Only process paths matching this regex.")
        parser.add_argument("--lock-strategy", type=str.upper,
                            choices=["FILE", "DB", "NONE"], default="DB")
        parser.add_argument("--lock-level", type=str.upper,
                            choices=["PAGE", "TASK"], default="PAGE")
        parser.add_argument("--lock-database", type=str, default=None)
        parser.add_argument("--lock-timeout", type=int, default=60)
        parser.add_argument("--max-lock-age", type=int, default=600)
        parser.add_argument("--overwrite", action="store_true",
                            help="Recompute and overwrite existing "
                                 "artifacts.")
        parser.add_argument("--profile", action="store_true",
                            help="Profile processing (cProfile and a "
                                 "torch.profiler trace); overwrites.")
        parser.add_argument("--plain", action="store_true",
                            help="Pipe-friendly plain output.")
        parser.add_argument("--debug-write", action="store_true",
                            help="Print every artifact write.")
        parser.add_argument("--track-changes", type=str, default="",
                            help="Recompute artifacts, marking changed "
                                 "ones.")
        parser.add_argument("--device", type=str, default="cuda",
                            help="torch device: cuda (default) or cpu")

    @property
    def processor_name(self):
        return self.__class__.__name__

    # -- stage contract ----------------------------------------------------
    def artifacts(self):
        """Override: [(kwarg_name, Input(...)/Output(...)), ...]."""
        return []

    def should_process(self, page_path):
        return True

    # -- queue construction ------------------------------------------------
    def _file_writer(self):
        if self._track_changes:
            return TrackChangeWriter(self._track_changes)
        w = AtomicFileWriter(overwrite=self._overwrite)
        if self._debug_write:
            w = DebuggingFileWriter(w)
        return w

    def prepare_process(self, page_path):
        kwargs = {}
        writer = self._file_writer()
        for arg, spec in self.artifacts():
            f = spec.instantiate(page_path=page_path, processor=self,
                                 file_writer=writer)
            f.fix_inconsistent()
            if not f.is_ready():
                return False
            kwargs[arg] = f
        return kwargs

    def _queue_add(self, queued, p):
        if not p.exists():
            return
        if self._name_filter and not re.search(self._name_filter, str(p)):
            return
        if not is_image(p) or not self.should_process(p):
            return
        kwargs = self.prepare_process(p)
        if kwargs is not False:
            queued.append((len(queued), p, kwargs))

    def _build_queue(self, path):
        if isinstance(path, (list, tuple)):
            queued = []
            for p in path:
                self._queue_add(queued, Path(p))
            return queued
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(path)
        queued = []
        if path.is_dir():
            for folder, dirs, files in os.walk(path):
                folder = Path(folder)
                if folder.name.endswith(".out"):
                    dirs.clear()
                    continue
                dirs.sort()
                for fn in sorted(files):
                    self._queue_add(queued, folder / fn)
        elif path.suffix == ".txt":
            for line in path.read_text().splitlines():
                if line.strip():
                    self._queue_add(queued, Path(line.strip()))
        else:
            self._queue_add(queued, path)
        return queued

    # -- execution ---------------------------------------------------------
    def lock_or_open(self, path, mode):
        if self._lock_strategy == "FILE":
            import portalocker
            return portalocker.Lock(path, mode, flags=portalocker.LOCK_EX,
                                    timeout=1, fail_when_locked=True)
        return open(path, mode)

    def _make_mutex(self, path):
        if isinstance(path, (list, tuple)):
            path = Path(path[0]).parent if path else Path(".")
        if self._lock_strategy == "DB":
            if self._lock_database:
                db = Path(self._lock_database)
            elif Path(path).is_dir():
                db = Path(path) / "origami.lock.db"
            else:
                db = Path(path).parent / "origami.lock.db"
            m = _mutex.DatabaseMutex(db, timeout=self._lock_timeout)
            m.clear_locks(self._max_lock_age)
            return m
        return _mutex.make_mutex(self._lock_strategy)

    def traverse(self, path):
        from origami_tpu_torch.parallel import multihost
        multi = multihost.maybe_initialize()
        if not self._plain:
            print("running %s." % self.processor_name, flush=True)
        queued = self._build_queue(path)
        if multi:
            # deterministic sharding over the processes: each queues only
            # the pages whose stable hash lands on its rank (the locks
            # still guard against overlapping fleets)
            index, count = multihost.process_info()
            keep = set(multihost.my_pages(
                [p for _, p, _ in queued], index=index, count=count))
            queued = [(j, p, kw) for j, (_, p, kw) in enumerate(
                q for q in queued if q[1] in keep)]
            print("host %d/%d: %d pages assigned."
                  % (index, count, len(queued)), flush=True)
        self._mutex = self._make_mutex(path)
        profiler = device_trace = None
        if self._profile:
            import cProfile

            import torch.profiler
            p0 = Path(path[0]) if isinstance(path, (list, tuple)) \
                else Path(path)
            trace_dir = (p0 if p0.is_dir() else p0.parent) / "torch-trace"
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            device_trace = torch.profiler.profile(activities=activities)
            profiler = cProfile.Profile()
            device_trace.__enter__()
            profiler.enable()
        try:
            self._process_queue(queued)
        finally:
            self._mutex = None
            if profiler is not None:
                import pstats
                profiler.disable()
                device_trace.__exit__(None, None, None)
                trace_dir.mkdir(parents=True, exist_ok=True)
                device_trace.export_chrome_trace(
                    str(trace_dir / ("%s.json" % self.processor_name)))
                pstats.Stats(profiler).sort_stats(
                    "cumulative").print_stats(30)

    def _process_queue(self, queued):
        raise NotImplementedError

    # -- runtime.json ------------------------------------------------------
    _runtime_write_lock = threading.Lock()

    def _update_runtime_info(self, page_path, updates):
        with Processor._runtime_write_lock:
            try:
                data_path = find_data_path(page_path)
                data_path.mkdir(exist_ok=True)
                json_path = data_path / Artifact.RUNTIME.filename()
                data = {}
                if json_path.exists():
                    try:
                        data = json.loads(json_path.read_text())
                    except json.JSONDecodeError:
                        data = {}
                for k, v in updates.items():
                    if v is None:
                        data.pop(k, None)
                    else:
                        data[k] = v
                tmp = json_path.parent / (json_path.stem + ".updated.json")
                tmp.write_text(json.dumps(data))
                os.replace(tmp, json_path)
            except OSError:
                logging.error(traceback.format_exc())


class BatchedProcessor(Processor):
    """Device-batched stage: processes ready pages in groups of
    `batch_size`; locking is per batch, failures are captured per page.
    Subclasses implement `process_batch([(page_path, kwargs)])` and
    return {page_path: info}. They may override `preload(page_path)`,
    which runs on a thread pool for the NEXT batch while the device
    works on the current one; its result arrives as
    kwargs["_preloaded"] (None where it raised: the page then loads, and
    fails, inside process_batch, where the failure is recorded)."""

    PRELOAD_THREADS = 4
    # True for the host stages, which run --processes workers
    POOLED = False
    LOCK_CHUNK_SIZE = 25

    def __init__(self, options=None, batch_size=8):
        super().__init__(options)
        self._batch_size = batch_size

    def process_batch(self, pages):
        raise NotImplementedError

    def preload(self, page_path):
        """Override: host-side IO for one page (decode)."""
        return None

    def spawn_factory(self):
        """(callable, args) rebuilding this processor in a worker."""
        return self.__class__, (self._options,)

    def _run_chunk_paths(self, chunk):
        """Worker side: chunk = [(i, path)]. Each page is registered in
        the shared in-flight work set while it runs, its readers and
        writers are built here, and it runs as a batch of one under its
        own lock. Yields (i, path) as each page ends."""
        actor = "page" if self._lock_level == "PAGE" else self.processor_name
        pid = os.getpid()
        for i, p in chunk:
            if _worker_work_set is not None:
                _worker_work_set[pid] = (str(p), time.time())
            kwargs = self.prepare_process(p)
            if kwargs is not False:
                try:
                    kwargs["_preloaded"] = self.preload(p)
                except Exception as e:
                    logging.warning("preload of %s failed: %s", p, e)
                    kwargs["_preloaded"] = None
                self._run_batch_chunk([(i, p, kwargs)], actor)
            yield i, p

    def _process_pool(self, queued, progress):
        """--processes > 1 (`progress(pages)` reports ended pages):
        spawned workers (not forked: the parent may
        hold a CUDA context, which a forked child cannot use) rebuild
        the processor via spawn_factory and run chunks of page paths; a
        Watchdog ends the pool when no page completes for --alive
        seconds (a worker taking up a chunk counts as progress too), and
        the run then exits with status 1."""
        ctx = multiprocessing.get_context("spawn")
        heartbeat = ctx.Value("d", time.time())
        factory, fargs = self.spawn_factory()
        # chunks of LOCK_CHUNK_SIZE pages, smaller where the queue is
        # short, so that every worker gets pages
        size = max(1, min(self.LOCK_CHUNK_SIZE,
                          -(-len(queued) // self._processes)))
        path_chunks = [[(i, str(p)) for i, p, _ in chunk]
                       for chunk in _chunks(queued, size)]
        poll = min(0.1, self._timeout / 8)
        with ctx.Manager() as manager:
            work_set = manager.dict()
            with ctx.Pool(self._processes, maxtasksperchild=4,
                          initializer=_worker_init,
                          initargs=(factory, fargs, heartbeat, self._mutex,
                                    work_set)) as pool:
                watchdog = Watchdog(pool, self._timeout, heartbeat,
                                    work_set=work_set)
                watchdog.start()
                results = pool.imap_unordered(_worker_run_chunk,
                                              path_chunks)
                left = len(path_chunks)
                while left and not watchdog.cancelled:
                    try:
                        pages, launched = results.next(timeout=poll)
                    except multiprocessing.TimeoutError:
                        continue
                    left -= 1
                    heartbeat.value = time.time()
                    _add_launches(launched)
                    progress([p for _i, p in pages])
                watchdog.set_done()
                self.stuck = list(watchdog.stuck)
        if watchdog.cancelled:
            sys.exit(1)

    def _process_queue(self, queued):
        n = len(queued)
        if n == 0:
            if not self._plain:
                print("nothing to process.")
            return
        done = 0
        t0 = time.time()

        def progress(pages):
            nonlocal done
            done += len(pages)
            if self._plain:
                for p in pages:
                    print("[%d/%d] %s" % (done, n, p), flush=True)
            else:
                rate = done / max(time.time() - t0, 1e-6)
                print("\r[%d/%d] %.2f pages/s" % (done, n, rate),
                      end="" if done < n else "\n", flush=True)

        if self._processes > 1:
            if self.POOLED:
                self._process_pool(queued, progress)
                return
            print("%s is a batched stage: it runs in one process "
                  "(--processes %d asked)" % (self.processor_name,
                                              self._processes), flush=True)
        actor = "page" if self._lock_level == "PAGE" else self.processor_name
        chunks = list(_chunks(queued, self._batch_size))
        with ThreadPoolExecutor(max_workers=self.PRELOAD_THREADS) as pool:

            def prefetch(chunk):
                return [pool.submit(self.preload, p) for _, p, _kw in chunk]

            futures = prefetch(chunks[0])
            for ci, chunk in enumerate(chunks):
                following = prefetch(chunks[ci + 1]) \
                    if ci + 1 < len(chunks) else []
                for (_, p, kw), f in zip(chunk, futures):
                    try:
                        kw["_preloaded"] = f.result()
                    except Exception as e:
                        logging.warning("preload of %s failed: %s", p, e)
                        kw["_preloaded"] = None
                futures = following
                self._run_batch_chunk(chunk, actor)
                progress([p for _, p, _kw in chunk])

    def _run_batch_chunk(self, chunk, actor):
        with self._mutex.lock(actor,
                              [str(p) for _, p, _ in chunk]) as locked:
            if not locked:
                logging.warning(
                    "batch of %d pages is locked elsewhere; skipping "
                    "(stale locks? see --max-lock-age)", len(chunk))
                return
            ready = [(p, kw) for _, p, kw in chunk
                     if all(f.is_ready() for f in kw.values()
                            if hasattr(f, "is_ready"))]
            if not ready:
                return
            for p, _kw in ready:
                find_data_path(p).mkdir(exist_ok=True)
            t0 = time.perf_counter()
            try:
                infos = self.process_batch(ready) or {}
            except KeyboardInterrupt:
                raise
            except Exception:
                # the batch boundary: record the traceback on every page
                # of the batch and go on with the next batch
                logging.exception("batch failed")
                for p, _kw in ready:
                    self._update_runtime_info(
                        p, {self.processor_name: dict(
                            status="FAILED",
                            traceback=traceback.format_exc())})
                return
            per_page = round((time.perf_counter() - t0)
                             / max(len(ready), 1), 2)
            for p, _kw in ready:
                info = dict(infos.get(p, {}))
                info.setdefault("status", "COMPLETED")
                info["elapsed"] = per_page
                self._update_runtime_info(p, {self.processor_name: info})


class PageProcessor(BatchedProcessor):
    """A host stage that takes one page at a time: `process(page_path,
    **artifacts)` gets the readers and writers its `artifacts()` name
    (the JAX package's plain Processor contract)."""

    POOLED = True

    def __init__(self, options):
        super().__init__(options, batch_size=1)

    def process_batch(self, pages):
        return {p: self.process(p, **{k: v for k, v in kw.items()
                                      if not k.startswith("_")}) or {}
                for p, kw in pages}


def run_cli(cls, argv, prog, description, add_options=None):
    """The command line of a one-class stage: parse `argv` (the options
    `add_options(parser)` adds, DATA_PATH and the runtime options), build
    `cls` from them and traverse DATA_PATH. -> the processor."""
    import argparse
    p = argparse.ArgumentParser(prog=prog, description=description)
    if add_options is not None:
        add_options(p)
    p.add_argument("data_path", type=str)
    Processor.add_arguments(p)
    args = p.parse_args(argv)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    stage = cls(vars(args))
    stage.traverse(args.data_path)
    return stage
