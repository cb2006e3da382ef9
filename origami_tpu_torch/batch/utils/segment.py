"""utils.segment — convert legacy segmentation artifacts to segment.zip.

Port of origami_tpu/batch/utils/segment.py: each page whose `.out`
folder holds a legacy `segmentation.pickle` gets a segment.zip
(tool/migrate.convert_legacy_segmentation), unless one is there and
--overwrite is not given. Host work only: `--device` is taken as every
stage takes it.

    python -m origami_tpu_torch.batch.utils.segment CORPUS [--overwrite] \\
        [--device cpu]
"""

from __future__ import annotations

from origami_tpu_torch.batch.core.io import find_data_path
from origami_tpu_torch.batch.core.processor import PageProcessor, run_cli
from origami_tpu_torch.tool.migrate import convert_legacy_segmentation


class SegmentConverterProcessor(PageProcessor):
    def __init__(self, options):
        options = dict(options)
        options.setdefault("lock_strategy", "NONE")
        # the count lives in this process
        options["processes"] = 1
        super().__init__(options)
        self.n_converted = 0

    @property
    def processor_name(self):
        return "origami_tpu.batch.utils.segment"

    def artifacts(self):
        return []

    def prepare_process(self, page_path):
        return {}

    def process(self, page_path):
        data_path = find_data_path(page_path)
        legacy = data_path / "segmentation.pickle"
        target = data_path / "segment.zip"
        if legacy.exists() and (self._overwrite or not target.exists()):
            convert_legacy_segmentation(legacy, target)
            self.n_converted += 1


def main(argv=None):
    p = run_cli(SegmentConverterProcessor, argv,
                "python -m origami_tpu_torch.batch.utils.segment",
                "Convert legacy segmentation artifacts in DATA_PATH.")
    print("converted %d pages." % p.n_converted)
    return p


if __name__ == "__main__":
    main()
