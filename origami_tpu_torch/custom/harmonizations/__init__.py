"""Harmonization schemas (tool.harmonize NAME): `default` and `bbz`,
copied whole from origami_tpu/custom/harmonizations/ as data."""
