"""Remote corpus runner (port of origami_tpu/batch/remote/)."""
