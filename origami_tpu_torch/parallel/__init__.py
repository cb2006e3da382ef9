"""Scale-out (port of origami_tpu/parallel/): the page assignment of a
multi-process launch (multihost), a (data x model) grid of devices
(mesh), the parameter rules of the model axis (sharding; the training
steps over a mesh are train/mesh.py) and the multi-device dry run
(dryrun).

origami_tpu/parallel/cache.py (XLA's compile cache) has no counterpart:
ops/_build.py caches the nvcc build.
"""
