"""Registration of population-level ("batched") operator forms.

``batched_op(op, impl)`` marks ``impl`` as ``op``'s batched variant and
back-links ``impl.base_op = op``, so a decorated operator (whose wrapper
copied ``batched`` but is not ``base_op``) falls back to the per-row
path and its decorator is honoured."""

from __future__ import annotations

from typing import Callable


def batched_op(op: Callable, impl: Callable) -> Callable:
    impl.base_op = op
    op.batched = impl
    return op
