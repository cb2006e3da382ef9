"""Scale-out for serving (port of origami_tpu/parallel/): the page
assignment of a multi-process launch (multihost), a data axis over the
visible devices (mesh) and the serving half of the multi-device dry run
(dryrun).

origami_tpu/parallel/cache.py (XLA's compile cache) has no counterpart:
ops/_build.py caches the nvcc build.
"""
