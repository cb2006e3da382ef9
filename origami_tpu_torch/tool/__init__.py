"""Operator tools (port of origami_tpu/tool/): `migrate` so far."""
