"""Legacy artifact migration.

Port of origami_tpu/tool/migrate.py: convert legacy pickled segmentation
artifacts (`segmentation.pickle`) into segment.zip through the port's
core/segment.py, rename old artifact files to the current names, and
import a reference model directory's meta.json contract into a model
directory with freshly initialized parameters (the port's
registry.init_and_save). The pickles are the reference system's own
artifacts: unpickling runs code, so migrate only corpora that system
wrote.

    python -m origami_tpu_torch.tool.migrate DATA_PATH [--dry-run]
    python -m origami_tpu_torch.tool.migrate OUT_DIR --import-model DIR
"""

from __future__ import annotations

import argparse
import io
import json
import pickle
from pathlib import Path

import numpy as np

from origami_tpu_torch.core.segment import Prediction, Segmentation


def convert_legacy_segmentation(pickle_path, out_path):
    """Legacy pickle: list of (key, (enum_name, classes_dict, npz_bytes))
    tuples -> segment.zip."""
    with open(pickle_path, "rb") as f:
        data = pickle.load(f)
    predictions = []
    for _k, (enum_name, enum_dict, labels_data) in data:
        kind = "REGION" if "Region" in enum_name else "SEPARATOR"
        with io.BytesIO(labels_data) as buf:
            labels = np.load(buf)["arr_0"]
        predictions.append(Prediction(
            kind, kind.lower() + "s", labels, enum_dict))
    Segmentation(predictions).save(out_path)


_RENAMES = {
    "segmentation.zip": "segment.zip",
    "contours.zip": "contours.0.zip",
    "lines.zip": "lines.0.zip",
}


def _h5_summary(h5):
    """The Keras file's version and parameter count, or the error that
    reading it raised (h5py is optional)."""
    try:
        import h5py
        with h5py.File(str(h5), "r") as f:
            n_params = 0

            def count(name, obj):
                nonlocal n_params
                if hasattr(obj, "shape") and obj.shape is not None:
                    n_params += int(np.prod(obj.shape))
            f.visititems(count)
            version = f.attrs.get("keras_version", "")
            return dict(
                keras_version=(version or b"").decode("utf8", "ignore")
                if isinstance(version, bytes) else str(version),
                n_params=n_params)
    except Exception as e:   # any failure is recorded, as the JAX tool does
        return dict(error=str(e))


def import_model_meta(network_path, out_path, width=1.0, s2d=4, seed=0):
    """Import a reference model directory's meta.json contract
    (classes/type/full_size/tile_size/tile_beta) into a model directory.

    The reference's Keras .h5 weights do not convert: the directory gets
    freshly initialized parameters and must be retrained; the .h5 is
    summarized in `imported_from.h5` so the operator can check what the
    source model was."""
    from origami_tpu_torch.models import registry
    network_path = Path(network_path)
    src = json.loads((network_path / "meta.json").read_text())
    h5 = network_path / "model.h5"
    meta = dict(
        kind="unet",
        type=src["type"].lower(),
        classes=list(src["classes"]),
        full_size=list(src.get("full_size", [1280, 2400])),
        tile_size=list(src.get("tile_size",
                                src.get("full_size", [1280, 896]))),
        tile_beta=src.get("tile_beta", 50),
        width=width, s2d=s2d, channels=1, version=1,
        imported_from=dict(
            meta=str(network_path / "meta.json"),
            model=src.get("model"), backbone=src.get("backbone"),
            h5=_h5_summary(h5) if h5.exists() else None,
            note="reference Keras weights are not convertible; "
                 "parameters are freshly initialized - retrain "
                 "(train.segment) or distill onto this meta"))
    registry.init_and_save(Path(out_path), meta, seed=seed)
    return meta


def migrate(data_path, dry_run=False):
    """Rename old artifact files and convert legacy pickles under every
    `*.out` folder of DATA_PATH -> the number of artifacts migrated."""
    n = 0
    for out_dir in Path(data_path).glob("**/*.out"):
        if not out_dir.is_dir():
            continue
        for old, new in _RENAMES.items():
            src = out_dir / old
            dst = out_dir / new
            if src.exists() and not dst.exists():
                if dry_run:
                    print("would rename %s -> %s" % (src, dst))
                else:
                    src.rename(dst)
                n += 1
        legacy = out_dir / "segmentation.pickle"
        if legacy.exists():
            if dry_run:
                print("would convert %s" % legacy)
            else:
                convert_legacy_segmentation(legacy,
                                            out_dir / "segment.zip")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.migrate",
        description="Migrate legacy artifact layouts under DATA_PATH.")
    p.add_argument("data_path", type=str)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--import-model", type=str, default=None,
                   help="treat DATA_PATH as the OUTPUT model dir and "
                        "import the reference model directory given here "
                        "(meta.json contract; weights need retraining)")
    args = p.parse_args(argv)
    if args.import_model:
        if not Path(args.import_model).exists():
            raise SystemExit("no such path: %s" % args.import_model)
        meta = import_model_meta(args.import_model, args.data_path)
        print("imported %s -> %s (%s/%s)" % (
            args.import_model, args.data_path, meta["type"],
            ",".join(meta["classes"])))
        return
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    print("migrated %d artifacts." % migrate(args.data_path, args.dry_run))


if __name__ == "__main__":
    main()
