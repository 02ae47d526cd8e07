"""Registration of population-level operator forms.

``batched_op(op, impl)`` marks ``impl`` as ``op``'s batched variant (one
key for the whole batch) and back-links ``impl.base_op = op``, so a
decorated operator (whose wrapper copied ``batched`` but is not
``base_op``) falls back to the per-row path and its decorator is
honoured.

``rowwise_op(op)`` marks an operator written over a leading row axis
with one key per row: called with ``split(key, n)`` and the stacked
operands, row ``i`` equals the one-row operator on key ``i``.  It is the
port's stand-in for the JAX package's ``jax.vmap(tool)(split(key, n),
...)`` and gives the same numbers.  ``Toolbox.register`` copies the
function's ``__dict__``, so a registered partial keeps the mark.

A rowwise op also takes the JAX package's per-tree calling form: one key
``(w,)`` and operands without the row axis.  It then adds the row axis
to the key and to every tensor operand (tensors and tuples of tensors),
runs as a batch of one and strips the axis from what it returns.  That
is what the loop's one-call-per-row path hands an unmarked wrapper such
as ``lambda k, t: gp.mut_uniform(k, t, expr, pset)``, so the reference
examples' registrations run unchanged (one call per row)."""

from __future__ import annotations

import functools
from typing import Callable

import torch


def batched_op(op: Callable, impl: Callable) -> Callable:
    impl.base_op = op
    op.batched = impl
    return op


def _map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(_map_tensors(fn, v) for v in x)
    return x


def _add_row(x):
    return _map_tensors(lambda t: t[None], x)


def _strip_row(x):
    return _map_tensors(lambda t: t[0], x)


def rowwise_op(op: Callable) -> Callable:
    @functools.wraps(op)
    def call(keys, *args, **kwargs):
        if keys.ndim > 1:
            return op(keys, *args, **kwargs)
        out = op(keys[None], *map(_add_row, args),
                 **{k: _add_row(v) for k, v in kwargs.items()})
        return _strip_row(out)

    call.rowwise = True
    return call
