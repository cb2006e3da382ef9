"""GT annotation CLI over the annotation DB.

Port of origami_tpu/tool/annotate.py, its click group as argparse
subcommands: `list`, `set` and `stats` work on the DB alone;
`export-image` writes one line's strip (tool/lineload.load_line_image,
on the card unless told --device cpu) in the format its suffix names, as
PIL's `save` picks it: .jpg and .jpeg PIL's JPEG bytes at its default
quality (75), .tif and .tiff PIL's uncompressed TIFF, .bmp PIL's 8-bit
BMP, .png a PNG; any other suffix raises.

    python -m origami_tpu_torch.tool.annotate list --db-path DB \\
        [--unannotated] [--search TEXT] [--device cpu]
    python -m origami_tpu_torch.tool.annotate set --db-path DB --page P \\
        --line L --text TEXT [--author A]
    python -m origami_tpu_torch.tool.annotate export-image --db-path DB \\
        --page P --line L -o OUT.{jpg,png,tif,bmp} [--line-height 48]
    python -m origami_tpu_torch.tool.annotate stats --db-path DB
"""

from __future__ import annotations

import argparse
from pathlib import Path

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.lineload import AnnotationDB


def list_lines(db, unannotated=False, search=None):
    for rec in db.all_lines():
        if unannotated and rec["annotation"]:
            continue
        if search and search not in (rec["annotation"] or ""):
            continue
        print("%s\t%s\t%s" % (rec["page_path"], rec["line_path"],
                              rec["annotation"] or ""))


def set_annotation(db, page, line, text, author=None):
    db.add_line(page, line)
    db.update_annotation(page, line, text, author)
    print("annotated %s %s" % (page, line))


def _encoders():
    """{suffix: uint8 (H, W) -> file bytes}: the formats PIL's `save`
    picks by suffix that export-image writes."""
    from origami_tpu_torch.core import _bmp, _jpeg, _png, _tiff
    return {".jpg": _jpeg.encode, ".jpeg": _jpeg.encode,
            ".png": _png.encode_gray, ".tif": _tiff.encode_gray,
            ".tiff": _tiff.encode_gray, ".bmp": _bmp.encode_gray}


def export_image(page, line, output, line_height=48, device=None):
    """Write one line's image so it can be viewed while transcribing."""
    from origami_tpu_torch.tool.lineload import load_line_image
    suffix = Path(output).suffix.lower()
    encoders = _encoders()
    if suffix not in encoders:
        raise ValueError("export-image writes %s, not the suffix %r of %s"
                         % (", ".join(sorted(encoders)), suffix, output))
    strip = load_line_image(page, line, line_height, device=device)
    Path(output).write_bytes(encoders[suffix](strip))
    print("wrote %s" % output)
    return strip


def db_stats(db):
    recs = db.all_lines()
    annotated = [r for r in recs if r["annotation"]]
    print("lines: %d, annotated: %d, training: %d, validation: %d" % (
        len(recs), len(annotated),
        sum(1 for r in recs if r["training"]),
        sum(1 for r in recs if r["validation"])))


def parser():
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.annotate",
        description="Browse and edit the GT annotation database.")
    sub = p.add_subparsers(dest="command", required=True)

    def command(name):
        s = sub.add_parser(name)
        s.add_argument("--db-path", type=str, required=True)
        add_device_argument(s)
        return s

    s = command("list")
    s.add_argument("--unannotated", action="store_true")
    s.add_argument("--search", type=str, default=None)
    s = command("set")
    s.add_argument("--page", type=str, required=True)
    s.add_argument("--line", type=str, required=True)
    s.add_argument("--text", type=str, required=True)
    s.add_argument("--author", type=str, default=None)
    s = command("export-image")
    s.add_argument("--page", type=str, required=True)
    s.add_argument("--line", type=str, required=True)
    s.add_argument("-o", "--output", type=str, required=True)
    s.add_argument("--line-height", type=int, default=48)
    command("stats")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    device = _device.resolve(args.device)
    if not Path(args.db_path).exists():
        raise SystemExit("no such path: %s" % args.db_path)
    if args.command == "export-image":
        return export_image(args.page, args.line, args.output,
                            args.line_height, device)
    db = AnnotationDB(args.db_path)
    if args.command == "list":
        list_lines(db, args.unannotated, args.search)
    elif args.command == "set":
        set_annotation(db, args.page, args.line, args.text, args.author)
    else:
        db_stats(db)


if __name__ == "__main__":
    main()
