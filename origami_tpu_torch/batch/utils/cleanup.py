"""utils.cleanup — remove corrupt and stale files from a corpus.

Port of origami_tpu/batch/utils/cleanup.py: in every page's `.out`
folder, delete temporary files and JSON files that do not parse, and
drop the FAILED entries of runtime.json (their stages run again). Host
work only: `--device` is taken as every stage takes it.

    python -m origami_tpu_torch.batch.utils.cleanup CORPUS [--dry-run] \\
        [--device cpu]
"""

from __future__ import annotations

import json
import os

from origami_tpu_torch.batch.core.io import find_data_path
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


class CleanupProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        super().__init__(options)
        self._dry = options.get("dry_run", False)
        self.removed = 0
        self.fixed = 0

    def artifacts(self):
        return []

    def prepare_process(self, page_path):
        return {}

    def _remove(self, p):
        if self._dry:
            print("would remove %s" % p)
        else:
            os.remove(p)
        self.removed += 1

    def process(self, page_path):
        data_path = find_data_path(page_path)
        if not data_path.exists():
            return
        for p in list(data_path.iterdir()):
            if p.name.startswith("tmp") or p.suffix == ".tmp":
                self._remove(p)
            elif p.suffix == ".json":
                try:
                    json.loads(p.read_text())
                except (json.JSONDecodeError, UnicodeDecodeError):
                    self._remove(p)
        # clear FAILED entries from runtime.json (they'll recompute)
        rt = data_path / "runtime.json"
        if rt.exists():
            try:
                data = json.loads(rt.read_text())
            except json.JSONDecodeError:
                return
            failed = [k for k, v in data.items()
                      if v.get("status") == "FAILED"]
            for k in failed:
                del data[k]
            if failed and not self._dry:
                rt.write_text(json.dumps(data))
                self.fixed += 1


def add_options(p):
    p.add_argument("--dry-run", action="store_true")


def main(argv=None):
    p = run_cli(CleanupProcessor, argv,
                "python -m origami_tpu_torch.batch.utils.cleanup",
                "Clean up corrupt or stale files in DATA_PATH.", add_options)
    print("removed %d files, cleared %d failure records."
          % (p.removed, p.fixed))
    return p


if __name__ == "__main__":
    main()
