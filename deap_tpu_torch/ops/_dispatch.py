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
function's ``__dict__``, so a registered partial keeps the mark."""

from __future__ import annotations

from typing import Callable


def batched_op(op: Callable, impl: Callable) -> Callable:
    impl.base_op = op
    op.batched = impl
    return op


def rowwise_op(op: Callable) -> Callable:
    op.rowwise = True
    return op
