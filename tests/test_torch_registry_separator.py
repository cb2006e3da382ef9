"""The port's msgpack reader against origami_tpu.models.registry
.load_model on the separator student U-Net (a file of its own: the JAX
loader initialises the full-size U-Net template, the slow part).

Tolerance: none — the leaves must be bit-identical.
"""

from pathlib import Path

import numpy as np

from origami_tpu.models import registry as jax_registry
from origami_tpu_torch.models import registry

MODEL = Path(__file__).resolve().parent.parent / \
    "models_pretrained/students/separator/00"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def assert_same_tree(port_tree, jax_tree):
    port = dict(_flatten(port_tree))
    ref = {k: np.asarray(v) for k, v in _flatten(jax_tree)}
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        assert port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port[k], v, err_msg="/".join(k))


def test_separator_student_params_equal_jax_load_model():
    _, jax_params, jax_meta = jax_registry.load_model(MODEL)
    params, meta = registry.load_params(MODEL)
    assert meta == jax_meta
    assert_same_tree(params, jax_params)
