"""Merge annotation databases.

Port of origami_tpu/tool/merge.py: the rows of the source DB are
upserted into the target, preferring non-empty annotations. Host work
only: `--device` is taken as every port CLI takes it.

    python -m origami_tpu_torch.tool.merge DB --with-db SRC \\
        [--prefer src|dst] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.lineload import AnnotationDB


def merge_dbs(dst_path, src_path, prefer="src"):
    dst = AnnotationDB(dst_path)
    src = AnnotationDB(src_path)
    n = 0
    for rec in src.all_lines():
        existing = [r for r in dst.lines_for_page(rec["page_path"])
                    if r["line_path"] == rec["line_path"]]
        if not existing:
            dst.add_line(rec["page_path"], rec["line_path"],
                         rec["annotation"], rec["author"],
                         rec["training"], rec["validation"])
            n += 1
        elif rec["annotation"] and (
                prefer == "src" or not existing[0]["annotation"]):
            dst.update_annotation(rec["page_path"], rec["line_path"],
                                  rec["annotation"], rec["author"])
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.merge",
        description="Merge WITH_DB into DB_PATH.")
    p.add_argument("db_path", type=str)
    p.add_argument("--with-db", type=str, required=True)
    p.add_argument("--prefer", choices=["src", "dst"], default="src")
    add_device_argument(p)
    args = p.parse_args(argv)
    _device.resolve(args.device)
    for path in (args.db_path, args.with_db):
        if not Path(path).exists():
            raise SystemExit("no such path: %s" % path)
    n = merge_dbs(args.db_path, args.with_db, args.prefer)
    print("merged %d lines." % n)
    return n


if __name__ == "__main__":
    main()
