"""Inspect and rewrite the precision of every matrix product in a program.

On a GPU a float32 `dot_general` without a stated precision may run in TF32
(about three decimal digits). The phasing path states
`lax.Precision.HIGHEST` on every contraction; `dot_precisions` lets a test
enforce that on the traced program (including products nested in scans,
conditionals and inner jits), and `with_precision` re-runs a function with
every product forced to another precision, to measure what a relaxed
setting would cost in accuracy.
"""
from __future__ import annotations

import jax
from jax.extend.core import ClosedJaxpr, Jaxpr, jaxpr_as_fun


def _sub_jaxprs(value):
    if isinstance(value, (ClosedJaxpr, Jaxpr)):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _eqns(jaxpr):
    jaxpr = jaxpr.jaxpr if isinstance(jaxpr, ClosedJaxpr) else jaxpr
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _eqns(sub)


def dot_precisions(fn, *args, **kwargs):
    """→ the `precision` parameter of every dot_general in fn's program, in
    trace order (None where the product states none)."""
    closed = jax.make_jaxpr(fn)(*args, **kwargs)
    return [eqn.params.get("precision") for eqn in _eqns(closed)
            if eqn.primitive.name == "dot_general"]


def _rewrite(jaxpr, precision):
    closed = isinstance(jaxpr, ClosedJaxpr)
    inner = jaxpr.jaxpr if closed else jaxpr
    eqns = []
    for eqn in inner.eqns:
        params = dict(eqn.params)
        if eqn.primitive.name == "dot_general":
            params["precision"] = (None if precision is None
                                   else (precision, precision))
        for key, value in eqn.params.items():
            if isinstance(value, (ClosedJaxpr, Jaxpr)):
                params[key] = _rewrite(value, precision)
            elif isinstance(value, (tuple, list)) and any(
                    isinstance(v, (ClosedJaxpr, Jaxpr)) for v in value):
                params[key] = type(value)(
                    _rewrite(v, precision)
                    if isinstance(v, (ClosedJaxpr, Jaxpr)) else v
                    for v in value)
        eqns.append(eqn.replace(params=params))
    inner = inner.replace(eqns=eqns)
    return ClosedJaxpr(inner, jaxpr.consts) if closed else inner


def with_precision(fn, precision):
    """fn with every dot_general forced to `precision` (a lax.Precision, or
    None for the backend default). Traces fn once per call signature."""
    def wrapped(*args):
        closed = jax.make_jaxpr(fn)(*args)
        out = jaxpr_as_fun(_rewrite(closed, precision))(*args)
        tree = jax.tree_util.tree_structure(jax.eval_shape(fn, *args))
        return jax.tree_util.tree_unflatten(tree, out)
    return wrapped
