"""GT export: annotation DB -> recognizer training files.

Port of origami_tpu/tool/export.py: each annotated line's strip at
`line_height` (tool/lineload.load_line_image: one remap_batch launch a
line on a page with a grid), binarized when asked (core/binarize: the
sauvola kernel once a strip), written as PNG; one .gt.txt per
harmonization channel; and the train/valid names in sets.json.

    python -m origami_tpu_torch.tool.export --db-path DB -o OUT \\
        [--line-height 48] [--schema default] [--channel default ...] \\
        [--valid-ratio 0.2] [--binarize "sauvola(window_size=15)"] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

from origami_tpu_torch.core import _png
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.lineload import AnnotationDB, load_line_image


def export_training_data(db_path, out_dir, line_height=48,
                         schema_name="default", channels=("default",),
                         valid_ratio=0.2, seed=0, binarize="", device=None):
    """-> (lines exported, lines skipped). `device` None means the card,
    raising without one."""
    from origami_tpu_torch import device as _device
    from origami_tpu_torch.tool.harmonize import Schema
    device = _device.resolve(device)
    schema = Schema.load(schema_name)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    db = AnnotationDB(db_path)
    records = db.all_lines(annotated_only=True)

    binarizer = None
    if binarize.strip():
        from origami_tpu_torch.core.binarize import from_string
        binarizer = from_string(binarize, device=device)

    names = []
    skipped = 0
    for rec in records:
        name = (Path(rec["page_path"]).stem + "-"
                + rec["line_path"].replace("/", "-"))
        try:
            strip = load_line_image(rec["page_path"], rec["line_path"],
                                    line_height, device=device)
        except (FileNotFoundError, KeyError):
            skipped += 1
            continue
        if binarizer is not None:
            strip = binarizer(strip)
        _png.write_gray(out_dir / (name + ".png"), strip)
        for channel in channels:
            text = schema.channels[channel].transform(rec["annotation"])
            suffix = ".gt.txt" if channel == "default" \
                else ".%s.gt.txt" % channel
            (out_dir / (name + suffix)).write_text(text)
        names.append((name, rec))

    # train/valid split honoring explicit flags, randomizing the rest
    rng = random.Random(seed)
    train, valid = [], []
    undecided = []
    for name, rec in names:
        if rec.get("validation"):
            valid.append(name)
        elif rec.get("training"):
            train.append(name)
        else:
            undecided.append(name)
    rng.shuffle(undecided)
    n_valid = max(0, int(len(undecided) * valid_ratio))
    valid += undecided[:n_valid]
    train += undecided[n_valid:]
    (out_dir / "sets.json").write_text(json.dumps(dict(
        train=sorted(train), valid=sorted(valid))))
    return len(names), skipped


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.export",
        description="Export annotated lines as recognizer training data.")
    p.add_argument("--db-path", type=str, required=True)
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("--line-height", type=int, default=48)
    p.add_argument("--schema", type=str, default="default")
    p.add_argument("--channel", dest="channels", type=str, action="append",
                   default=None)
    p.add_argument("--valid-ratio", type=float, default=0.2)
    p.add_argument("--binarize", type=str, default="")
    add_device_argument(p)
    args = p.parse_args(argv)
    if not Path(args.db_path).exists():
        raise SystemExit("no such path: %s" % args.db_path)
    n, skipped = export_training_data(
        args.db_path, args.output, args.line_height, args.schema,
        tuple(args.channels or ("default",)), args.valid_ratio,
        binarize=args.binarize, device=args.device)
    print("exported %d lines (%d skipped)." % (n, skipped))
    return n, skipped


if __name__ == "__main__":
    main()
