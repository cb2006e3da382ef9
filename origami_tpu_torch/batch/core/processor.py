"""Batch runtime: corpus traversal, work queue, locks, runtime.json.

Port of origami_tpu/batch/core/processor.py for device-batched stages:
walk a corpus directory, queue the pages whose declared inputs exist and
whose outputs do not (:225-288), process them in page batches under the
lock strategy, record each page's status in runtime.json — a failure is
captured with its traceback and the batch loop keeps going.

Every processor carries a `torch.device` (the `device` option, "cuda"
unless the caller asks for "cpu"); the JAX runtime's multihost sharding,
compile cache, cProfile hook and process pool stay out.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from origami_tpu_torch.batch.core import mutex as _mutex
from origami_tpu_torch.batch.core.io import (
    AtomicFileWriter, Artifact, find_data_path)
from origami_tpu_torch.core.page import is_image
from origami_tpu_torch.device import resolve


def _chunks(items, n):
    for i in range(0, len(items), n):
        yield items[i:i + n]


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
        for name in ("profile", "debug_write", "track_changes"):
            if options.get(name):
                raise NotImplementedError(
                    "--%s is not ported (ROADMAP.md, queue A)"
                    % name.replace("_", "-"))
        self.device = resolve(options.get("device"))
        self._mutex = None

    # -- CLI ---------------------------------------------------------------
    @staticmethod
    def add_arguments(parser):
        """The JAX CLI's runtime options (names and defaults), plus
        --device."""
        parser.add_argument("--processes", type=int, default=1,
                            help="Number of parallel worker processes "
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
                            help="(not ported)")
        parser.add_argument("--plain", action="store_true",
                            help="Pipe-friendly plain output.")
        parser.add_argument("--debug-write", action="store_true",
                            help="(not ported)")
        parser.add_argument("--track-changes", type=str, default="",
                            help="(not ported)")
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
    def prepare_process(self, page_path):
        kwargs = {}
        writer = AtomicFileWriter(overwrite=self._overwrite)
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
        if not self._plain:
            print("running %s." % self.processor_name, flush=True)
        queued = self._build_queue(path)
        self._mutex = self._make_mutex(path)
        try:
            self._process_queue(queued)
        finally:
            self._mutex = None

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

    def __init__(self, options=None, batch_size=8):
        super().__init__(options)
        self._batch_size = batch_size

    def process_batch(self, pages):
        raise NotImplementedError

    def preload(self, page_path):
        """Override: host-side IO for one page (decode)."""
        return None

    def _process_queue(self, queued):
        n = len(queued)
        if n == 0:
            if not self._plain:
                print("nothing to process.")
            return
        done = 0
        t0 = time.time()
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
                done += len(chunk)
                if self._plain:
                    for _, p, _kw in chunk:
                        print("[%d/%d] %s" % (done, n, p), flush=True)
                else:
                    rate = done / max(time.time() - t0, 1e-6)
                    print("\r[%d/%d] %.2f pages/s" % (done, n, rate),
                          end="" if done < n else "\n", flush=True)

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
