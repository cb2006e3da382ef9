"""Remote corpus runner: pull pages from a remote host, process them
here, push the artifacts back.

Port of origami_tpu/batch/remote/runner.py: the system ssh/scp through
subprocess, a sqlite task DB (remote path, status, signature, time)
that lets an interrupted run resume past the pages marked DONE, and
FAILED on a transport error. The CLI runs the port's segment (`-m`,
heuristic by default) and contours stages on each page, on the card
unless told --device cpu.

    python -m origami_tpu_torch.batch.remote --host HOST \\
        --remote-dir DIR [--work-dir DIR] [--model heuristic] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import sqlite3
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from origami_tpu_torch.tool import add_device_argument


def file_digest(path, h=None):
    h = h or hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def signature(path):
    st = Path(path).stat()
    return "%d:%d:%s" % (st.st_mtime_ns, st.st_size, file_digest(path))


class TaskDB:
    """Tracks which remote pages were processed (resume support)."""

    def __init__(self, path):
        self._conn = sqlite3.connect(str(path))
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS tasks ("
            " remote_path TEXT PRIMARY KEY,"
            " status TEXT NOT NULL,"
            " signature TEXT,"
            " time REAL)")
        self._conn.commit()

    def status(self, remote_path):
        row = self._conn.execute(
            "SELECT status FROM tasks WHERE remote_path = ?",
            (remote_path,)).fetchone()
        return row[0] if row else None

    def mark(self, remote_path, status, sig=None):
        self._conn.execute(
            "INSERT OR REPLACE INTO tasks "
            "(remote_path, status, signature, time) VALUES (?, ?, ?, ?)",
            (remote_path, status, sig, time.time()))
        self._conn.commit()


class RemoteCorpus:
    def __init__(self, host, remote_dir):
        self.host = host
        self.remote_dir = remote_dir.rstrip("/")

    def _ssh(self, cmd):
        return subprocess.run(
            ["ssh", self.host, cmd], capture_output=True, text=True,
            check=True).stdout

    def list_pages(self, extensions=(".png", ".jpg", ".jpeg", ".tif")):
        names = []
        out = self._ssh("ls -1 %s" % self.remote_dir)
        for line in out.splitlines():
            if Path(line).suffix.lower() in extensions:
                names.append(line.strip())
        return sorted(names)

    def pull(self, name, local_dir):
        subprocess.run(
            ["scp", "-q", "%s:%s/%s" % (self.host, self.remote_dir, name),
             str(local_dir)], check=True)

    def push_dir(self, local_out, name):
        remote_out = "%s/%s" % (self.remote_dir, name)
        subprocess.run(
            ["ssh", self.host, "mkdir -p %s" % remote_out], check=True)
        subprocess.run(
            ["scp", "-q", "-r"] + [str(p) for p in
                                   Path(local_out).iterdir()]
            + ["%s:%s/" % (self.host, remote_out)], check=True)


def run_remote(host, remote_dir, stages, work_dir=None, db_path=None):
    """Pull pages one by one, run the given stages' traverse on the
    local copy, push the `.out` artifacts back -> pages processed."""
    work_dir = Path(work_dir or tempfile.mkdtemp(prefix="origami_remote_"))
    work_dir.mkdir(parents=True, exist_ok=True)
    db = TaskDB(db_path or work_dir / "remote.tasks.db")
    corpus = RemoteCorpus(host, remote_dir)
    pages = corpus.list_pages()
    done = 0
    for name in pages:
        if db.status(name) == "DONE":
            continue
        db.mark(name, "RUNNING")
        try:
            corpus.pull(name, work_dir)
            local_page = work_dir / name
            for stage in stages:
                stage.traverse(local_page)
            out_dir = local_page.with_suffix(".out")
            if out_dir.exists():
                corpus.push_dir(out_dir, out_dir.name)
            db.mark(name, "DONE", signature(local_page))
            done += 1
        except subprocess.CalledProcessError as e:
            db.mark(name, "FAILED")
            print("failed %s: %s" % (name, e), file=sys.stderr)
    return done


def remote_stages(model="heuristic", device=None):
    """The CLI's stages: the port's segment stage with `model` and its
    contours stage, without locks."""
    from origami_tpu_torch.batch.detect.contours import ContoursProcessor
    from origami_tpu_torch.batch.detect.segment import SegmentationProcessor
    opts = dict(lock_strategy="NONE", plain=True, device=device)
    return [SegmentationProcessor(model, opts), ContoursProcessor(opts)]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.batch.remote",
        description="Process a remote corpus end to end, pushing "
                    "artifacts back.")
    p.add_argument("--host", type=str, required=True)
    p.add_argument("--remote-dir", type=str, required=True)
    p.add_argument("--work-dir", type=str, default=None)
    p.add_argument("-m", "--model", type=str, default="heuristic")
    add_device_argument(p)
    args = p.parse_args(argv)
    stages = remote_stages(args.model, args.device)
    n = run_remote(args.host, args.remote_dir, stages, args.work_dir)
    print("processed %d pages." % n)
    return n


if __name__ == "__main__":
    main()
