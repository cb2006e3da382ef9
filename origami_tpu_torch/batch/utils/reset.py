"""utils.reset — delete selected artifacts to roll a corpus back.

Port of origami_tpu/batch/utils/reset.py: each comma-separated spec
("contours/warped", "ocr", "annotation/layout", ...) names one file of
every page's `.out` folder, by the JAX package's file names. Host work
only: `--device` is taken as every stage takes it.

    python -m origami_tpu_torch.batch.utils.reset CORPUS -a SPECS \\
        [--dry-run] [--device cpu]
"""

from __future__ import annotations

import os

from origami_tpu_torch.batch.core.io import find_data_path, parse_artifact
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class ResetProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        super().__init__(options)
        self._specs = [parse_artifact(s.strip())
                       for s in options["artifacts"].split(",")
                       if s.strip()]
        self._dry = options.get("dry_run", False)
        self.n_removed = 0

    def artifacts(self):
        return []

    def prepare_process(self, page_path):
        return {}

    def process(self, page_path):
        data_path = find_data_path(page_path)
        if not data_path.exists():
            return
        for artifact, stage in self._specs:
            p = data_path / artifact.filename(stage)
            if p.exists():
                if self._dry:
                    print("would remove %s" % p)
                else:
                    os.remove(p)
                self.n_removed += 1


def add_options(p):
    p.add_argument("-a", "--artifacts", type=str, required=True,
                   help="comma-separated artifact specs, e.g. "
                        "'contours/warped, ocr'")
    p.add_argument("--dry-run", action="store_true")


def main(argv=None):
    p = run_cli(ResetProcessor, argv,
                "python -m origami_tpu_torch.batch.utils.reset",
                "Delete selected artifacts for all pages in DATA_PATH.",
                add_options)
    print("%s %d artifacts." % (
        "would remove" if p._dry else "removed", p.n_removed))
    return p


if __name__ == "__main__":
    main()
