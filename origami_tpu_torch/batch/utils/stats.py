"""utils.stats — artifact coverage, stage timings, error triage.

Port of origami_tpu/batch/utils/stats.py: the count of each artifact
over the corpus's pages, each runtime.json entry's elapsed seconds (min,
median, p90), the page names (--list-names), and the FAILED entries
grouped by traceback (--list-errors), also written to `errors.csv` in
the working directory. Host work only: `--device` is taken as every
stage takes it.

    python -m origami_tpu_torch.batch.utils.stats CORPUS [--list-names] \\
        [--list-errors] [--device cpu]
"""

from __future__ import annotations

import collections
import csv
import json
import logging
from pathlib import Path

import numpy as np

from origami_tpu_torch.batch.core.io import find_data_path
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli


def _table(rows, headers=None):
    rows = [list(map(str, r)) for r in rows]
    if headers:
        rows = [list(map(str, headers))] + rows
    if not rows:
        return ""
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = []
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out.append(sep)
    for j, r in enumerate(rows):
        out.append("| " + " | ".join(
            c.ljust(w) for c, w in zip(r, widths)) + " |")
        if headers and j == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


class StatsProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options["lock_strategy"] = "NONE"
        options["processes"] = 1
        super().__init__(options)
        self._list_names = options.get("list_names", False)
        self._list_errors = options.get("list_errors", False)
        self._names = []
        self._num_pages = 0
        self._artifacts = collections.defaultdict(int)
        self._times = collections.defaultdict(list)
        self._tracebacks = collections.defaultdict(
            lambda: collections.defaultdict(list))

    def artifacts(self):
        return []

    def prepare_process(self, page_path):
        return {}

    def process(self, page_path):
        self._num_pages += 1
        if self._list_names:
            self._names.append(Path(page_path).name)
        data_path = find_data_path(page_path)
        if not data_path.exists():
            return
        for p in sorted(data_path.iterdir()):
            if p.name.startswith(".") or p.name.startswith("tmp"):
                continue
            self._artifacts[p.name] += 1
            if p.name == "runtime.json":
                self._parse_runtime(page_path, p)

    def _parse_runtime(self, page_path, path):
        try:
            data = json.loads(path.read_text())
        except json.JSONDecodeError as e:
            logging.warning("bad json at %s: %s", path, e)
            return
        for batch, info in data.items():
            t = info.get("elapsed")
            if t is not None:
                self._times[batch].append(t)
            if self._list_errors and info.get("status") == "FAILED":
                self._tracebacks[batch][
                    info.get("traceback", "")].append(str(page_path))

    def print(self):
        if self._artifacts:
            print("artifacts.")
            rows = [["pages", self._num_pages]]
            rows += sorted(self._artifacts.items())
            print(_table(rows))
        if self._times:
            print("\nelapsed.")
            rows = []
            for k in sorted(self._times):
                v = self._times[k]
                rows.append((k, "%.1f" % np.min(v), "%.1f" % np.median(v),
                             "%.1f" % np.quantile(v, 0.9)))
            print(_table(rows, headers=["batch", "min", "median", "p90"]))
        if self._list_names:
            print("\nnames.")
            for n in self._names:
                print(n)
        if self._list_errors and self._tracebacks:
            print("\nerrors.")
            rows = []
            with open("errors.csv", "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["frequency", "batch", "traceback", "pages"])
                for batch in sorted(self._tracebacks):
                    for tb, pages in sorted(
                            self._tracebacks[batch].items()):
                        rows.append((batch, tb.strip().splitlines()[-1]
                                     if tb.strip() else "?",
                                     "%d: %s" % (len(pages),
                                                 Path(pages[0]).name)))
                        w.writerow([len(pages), batch, tb,
                                    ", ".join(pages)])
            print(_table(rows, headers=["batch", "error", "pages"]))


def add_options(p):
    p.add_argument("--list-names", action="store_true")
    p.add_argument("--list-errors", action="store_true")


def main(argv=None):
    p = run_cli(StatsProcessor, argv,
                "python -m origami_tpu_torch.batch.utils.stats",
                "Show processing stats for DATA_PATH.", add_options)
    p.print()
    return p


if __name__ == "__main__":
    main()
