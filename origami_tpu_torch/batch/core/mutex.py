"""Cross-process / cross-node page locking (a copy of
origami_tpu/batch/core/mutex.py).

A SQLite mutex table keyed by (path, processor), claimed with exclusive
transactions, exponential-backoff retry and stale-lock GC, plus file-lock
and no-op strategies (the reference's origami/batch/core/mutex.py),
built on stdlib sqlite3. `portalocker` is imported only by the FILE
strategy.
"""

from __future__ import annotations

import logging
import os
import socket
import sqlite3
import time
from contextlib import contextmanager
from pathlib import Path


def _retry(op, max_backoff=8):
    attempt = 0
    while True:
        try:
            return op()
        except sqlite3.OperationalError:
            if attempt > max_backoff:
                raise
            time.sleep(0.05 * (2 ** attempt))
            attempt += 1


class DatabaseMutex:
    """SQLite-backed lock table. Safe across processes and (over NFS with
    working POSIX locks) across nodes. Connections are opened lazily per
    process so instances can cross fork boundaries."""

    def __init__(self, path, timeout=10.0):
        self._path = str(path)
        self._timeout = float(timeout)
        self._pid = None
        self._conn = None
        self._ensure_schema()

    # -- pickling across fork/spawn ---------------------------------------
    def __getstate__(self):
        return {"path": self._path, "timeout": self._timeout}

    def __setstate__(self, state):
        self._path = state["path"]
        self._timeout = state["timeout"]
        self._pid = None
        self._conn = None

    def _connect(self):
        pid = os.getpid()
        if self._conn is None or self._pid != pid:
            self._conn = sqlite3.connect(
                self._path, timeout=self._timeout, isolation_level=None)
            self._conn.execute("PRAGMA busy_timeout=%d"
                               % int(self._timeout * 1000))
            self._pid = pid
        return self._conn

    def _ensure_schema(self):
        def op():
            conn = self._connect()
            conn.execute(
                "CREATE TABLE IF NOT EXISTS mutex ("
                " path TEXT NOT NULL,"
                " processor TEXT NOT NULL,"
                " pid INTEGER NOT NULL,"
                " host TEXT NOT NULL DEFAULT '',"
                " time REAL NOT NULL,"
                " PRIMARY KEY (path, processor))")
            # older DBs created before the host column existed
            cols = [r[1] for r in conn.execute(
                "PRAGMA table_info(mutex)")]
            if "host" not in cols:
                conn.execute("ALTER TABLE mutex ADD COLUMN "
                             "host TEXT NOT NULL DEFAULT ''")
        try:
            _retry(op)
        except sqlite3.OperationalError:
            logging.exception("mutex schema creation failed")

    def clear_locks(self, age=0):
        """Delete all locks (age=0) or locks older than `age` seconds;
        locks held by dead local PIDs are reclaimed regardless of age
        (reference behavior: dead worker slots pruned via psutil,
        processor.py:99-107)."""
        def op():
            conn = self._connect()
            if age:
                conn.execute("DELETE FROM mutex WHERE time < ?",
                             (time.time() - age,))
            else:
                conn.execute("DELETE FROM mutex")
        _retry(op)
        if age:
            self._reclaim_dead()

    def _reclaim_dead(self):
        """PID-based reclamation is only valid for locks taken on THIS
        host: with the DB shared across nodes (NFS), a remote process's
        PID may be absent locally while the lock is live. Rows from other
        hosts are left to age-based expiry (clear_locks(age))."""
        try:
            import psutil
        except ImportError:
            return
        local = socket.gethostname()

        def op():
            conn = self._connect()
            rows = list(conn.execute("SELECT path, processor, pid "
                                     "FROM mutex WHERE host = ?",
                                     (local,)))
            dead = [(p, proc, pid) for p, proc, pid in rows
                    if not psutil.pid_exists(pid)]
            if dead:
                logging.warning("reclaiming %d locks of dead pids",
                                len(dead))
                conn.executemany(
                    "DELETE FROM mutex WHERE path = ? AND "
                    "processor = ? AND pid = ?", dead)
        _retry(op)

    def try_lock(self, processor, paths):
        def op():
            conn = self._connect()
            try:
                conn.execute("BEGIN EXCLUSIVE")
                conn.executemany(
                    "INSERT INTO mutex (path, processor, pid, host, "
                    "time) VALUES (?, ?, ?, ?, ?)",
                    [(str(p), processor, os.getpid(),
                      socket.gethostname(), time.time())
                     for p in paths])
                conn.execute("COMMIT")
                return True
            except sqlite3.IntegrityError:
                conn.execute("ROLLBACK")
                return False
            except sqlite3.OperationalError:
                # leave the connection transaction-free so _retry's next
                # BEGIN EXCLUSIVE doesn't nest ("cannot start a
                # transaction within a transaction")
                self._rollback_quietly(conn)
                raise
        return _retry(op)

    def unlock(self, processor, paths):
        def op():
            conn = self._connect()
            try:
                conn.execute("BEGIN EXCLUSIVE")
                conn.executemany(
                    "DELETE FROM mutex WHERE path = ? AND "
                    "processor = ? AND pid = ?",
                    [(str(p), processor, os.getpid()) for p in paths])
                conn.execute("COMMIT")
            except sqlite3.OperationalError:
                self._rollback_quietly(conn)
                raise
        _retry(op)

    @staticmethod
    def _rollback_quietly(conn):
        if conn.in_transaction:
            try:
                conn.execute("ROLLBACK")
            except sqlite3.OperationalError:
                pass

    @contextmanager
    def lock(self, processor, paths):
        got = self.try_lock(processor, paths)
        try:
            yield got
        finally:
            if got:
                self.unlock(processor, paths)

    def held(self):
        def op():
            conn = self._connect()
            return list(conn.execute(
                "SELECT path, processor, pid, time FROM mutex"))
        return _retry(op)


class FileMutex:
    """Per-page exclusive file locks via portalocker (NFS-capable)."""

    @contextmanager
    def lock(self, processor, paths):
        import portalocker
        if len(paths) != 1:
            raise RuntimeError("FileMutex locks one page at a time")
        try:
            with portalocker.Lock(paths[0], "r", flags=portalocker.LOCK_EX,
                                  timeout=1, fail_when_locked=True):
                yield True
        except (portalocker.exceptions.AlreadyLocked,
                portalocker.exceptions.LockException):
            yield False


class NullMutex:
    """No-op locking for single-process runs."""

    def try_lock(self, processor, paths):
        return True

    def unlock(self, processor, paths):
        pass

    @contextmanager
    def lock(self, processor, paths):
        yield True


def make_mutex(strategy, db_path=None, timeout=10.0):
    s = (strategy or "none").upper()
    if s == "DB":
        return DatabaseMutex(db_path, timeout=timeout)
    if s == "FILE":
        return FileMutex()
    if s == "NONE":
        return NullMutex()
    raise ValueError(strategy)
