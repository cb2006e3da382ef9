"""Single-line GT picking CLI.

Port of origami_tpu/tool/pick.py: add or remove one line of the
annotation DB. Host work only: `--device` is taken as every port CLI
takes it.

    python -m origami_tpu_torch.tool.pick add|remove --db-path DB \\
        --page PAGE --line LINE [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.lineload import AnnotationDB


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.pick",
        description="Add or remove individual GT lines.")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("add", "remove"):
        s = sub.add_parser(name)
        s.add_argument("--db-path", type=str, required=True)
        s.add_argument("--page", type=str, required=True)
        s.add_argument("--line", type=str, required=True)
        add_device_argument(s)
    args = p.parse_args(argv)
    _device.resolve(args.device)
    if args.command == "add":
        AnnotationDB(args.db_path).add_line(args.page, args.line)
        print("added %s %s" % (args.page, args.line))
    else:
        if not Path(args.db_path).exists():
            raise SystemExit("no such path: %s" % args.db_path)
        AnnotationDB(args.db_path).remove_line(args.page, args.line)
        print("removed %s %s" % (args.page, args.line))


if __name__ == "__main__":
    main()
