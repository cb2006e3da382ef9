"""Corpus layout clustering over page signatures.

Port of origami_tpu/tool/cluster.py: k-means (tool/split.kmeans) over
the grid-count signatures that batch/utils/signature.py writes into each
page's signature.zip, printing (and with -o writing as JSON) each
cluster's pages. Host work only: `--device` is taken as every port CLI
takes it.

    python -m origami_tpu_torch.tool.cluster CORPUS [-k 8] [-o OUT.json] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import zipfile
from pathlib import Path

import numpy as np

from origami_tpu_torch import device as _device
from origami_tpu_torch.tool import add_device_argument
from origami_tpu_torch.tool.split import kmeans


def load_signatures(data_path):
    """-> (the `.out` folders that hold a signature, (N, F) float64
    unit rows of their concatenated grid counts, zero-padded to the
    longest)."""
    names, feats = [], []
    for sig_path in sorted(Path(data_path).glob("**/signature.zip")):
        try:
            with zipfile.ZipFile(sig_path) as zf:
                data = json.loads(zf.read("signature.json"))
        except (zipfile.BadZipFile, KeyError):
            continue
        counts = data.get("counts", {})
        if not counts:
            continue
        vec = np.concatenate([np.asarray(v, dtype=np.float64)
                              for _, v in sorted(counts.items())])
        names.append(str(sig_path.parent))
        feats.append(vec)
    if not feats:
        return [], np.zeros((0, 0))
    width = max(len(v) for v in feats)
    mat = np.zeros((len(feats), width))
    for i, v in enumerate(feats):
        mat[i, : len(v)] = v
        n = np.linalg.norm(mat[i])
        if n > 0:
            mat[i] /= n
    return names, mat


def cluster(data_path, k=8, output=None):
    """Print the clusters of DATA_PATH's pages -> {cluster: [page .out
    folders]}."""
    names, mat = load_signatures(data_path)
    if not names:
        print("no signatures found (run batch.utils.signature first).")
        return {}
    assign, _ = kmeans(mat, k)
    groups = {}
    for name, a in zip(names, assign):
        groups.setdefault(int(a), []).append(name)
    for gid, members in sorted(groups.items()):
        print("cluster %d (%d pages):" % (gid, len(members)))
        for m in members[:5]:
            print("   %s" % m)
        if len(members) > 5:
            print("   ...")
    if output:
        Path(output).write_text(json.dumps(
            {str(k): v for k, v in groups.items()}, indent=2))
    return groups


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m origami_tpu_torch.tool.cluster",
        description="Cluster page layouts in DATA_PATH by signature.")
    p.add_argument("data_path", type=str)
    p.add_argument("-k", type=int, default=8)
    p.add_argument("-o", "--output", type=str, default=None,
                   help="write cluster membership JSON here")
    add_device_argument(p)
    args = p.parse_args(argv)
    _device.resolve(args.device)
    if not Path(args.data_path).exists():
        raise SystemExit("no such path: %s" % args.data_path)
    return cluster(args.data_path, args.k, args.output)


if __name__ == "__main__":
    main()
