"""Small shared utilities (port of origami_tpu/core/utils.py)."""

from __future__ import annotations

import ast
import re


def build_func_from_string(spec, funcs):
    """Parse a mini-DSL spec like "sauvola(window_size=15)" or "otsu" into
    a configured callable (used for pluggable binarizers)."""
    spec = spec.strip()
    m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)(\((.*)\))?$", spec, re.S)
    if not m:
        raise ValueError("cannot parse spec %r" % spec)
    name = m.group(1)
    if name not in funcs:
        raise ValueError("unknown function %r (have %s)"
                         % (name, sorted(funcs)))
    args = []
    kwargs = {}
    body = m.group(3)
    if body and body.strip():
        call = ast.parse("f(%s)" % body, mode="eval").body
        for a in call.args:
            args.append(ast.literal_eval(a))
        for k in call.keywords:
            kwargs[k.arg] = ast.literal_eval(k.value)
    return lambda *a, **kw: funcs[name](*args, *a, **kwargs, **kw)
