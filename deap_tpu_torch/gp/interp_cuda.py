"""The CUDA stack-machine interpreter (K6) behind
:func:`deap_tpu_torch.gp.interp.make_population_evaluator` — the
counterpart of ``deap_tpu/gp/interp_pallas.py``.

The kernel (``deap_tpu_torch/kernels/gp_interp.cu``) dispatches on an
**opcode** per node, not on the node's Python function, so a primitive
set runs on the card only when every primitive's function is one the
kernel knows: :data:`OPCODES` names them and :func:`opcode_of` maps a
function to its opcode.  The known functions are PyTorch's and the
``operator`` module's ``add``/``sub``/``mul``/``neg`` and the port's own
:mod:`deap_tpu_torch.gp` primitives (XLA-form ``sin``/``cos``,
``protected_div``/``log``/``sqrt``, ``logistic``, the ``b_*`` boolean
ops).  Anything else raises :class:`KernelFormUnavailable` on a CUDA
request; ``backend="plain"`` runs it through the plain interpreter.

This module checks the kernel's input contract — the opcode table,
``0 <= codes < n_nodes`` (one host read of the codes' range per call),
a row of ``X`` for every argument — and launches K6 through
:func:`deap_tpu_torch.kernels.launch_gp_interp`, which checks devices,
dtypes, shapes and contiguity and counts the launch.  Trees must be valid prefix programs (every primitive has
its operands below it), as everything the generators and the variation
operators produce is; the kernel bounds its stack pointer, so a
malformed program cannot write outside its stack, but its result is
unspecified.  Nothing here falls back to the plain interpreter.
"""

from __future__ import annotations

import operator

import torch

__all__ = ["OPCODES", "KernelFormUnavailable", "opcode_of",
           "require_kernel_form", "evaluate"]

#: the kernel's opcodes (gp_interp.cu's ``enum Op``) and their arities
OPCODES = {"arg": 0, "const": 1, "add": 2, "sub": 3, "mul": 4, "div": 5,
           "neg": 6, "sin": 7, "cos": 8, "log": 9, "sqrt": 10, "lf": 11,
           "and": 12, "or": 13, "xor": 14, "not": 15, "if": 16}
_ARITY = {"add": 2, "sub": 2, "mul": 2, "div": 2, "neg": 1, "sin": 1,
          "cos": 1, "log": 1, "sqrt": 1, "lf": 1, "and": 2, "or": 2,
          "xor": 2, "not": 1, "if": 3}


class KernelFormUnavailable(ValueError):
    """A primitive set has a primitive the CUDA interpreter cannot run."""


def _known_functions() -> dict:
    from . import (b_and, b_if_then_else, b_not, b_or, b_xor, cos, logistic,
                   protected_div, protected_log, protected_sqrt, sin)
    return {
        torch.add: "add", operator.add: "add",
        torch.sub: "sub", torch.subtract: "sub", operator.sub: "sub",
        torch.mul: "mul", torch.multiply: "mul", operator.mul: "mul",
        protected_div: "div",
        torch.neg: "neg", torch.negative: "neg", operator.neg: "neg",
        sin: "sin", cos: "cos", protected_log: "log",
        protected_sqrt: "sqrt", logistic: "lf",
        b_and: "and", b_or: "or", b_xor: "xor", b_not: "not",
        b_if_then_else: "if"}


def opcode_of(func, arity: int) -> int:
    """The opcode of a primitive ``func`` of ``arity``, or ``-1``."""
    try:
        name = _known_functions().get(func)
    except TypeError:                   # an unhashable callable
        name = None
    if name is None or _ARITY[name] != arity:
        return -1
    return OPCODES[name]


def require_kernel_form(frozen) -> None:
    """Raise :class:`KernelFormUnavailable` if a primitive of the frozen
    set has no opcode."""
    if frozen.kernel_form_missing:
        raise KernelFormUnavailable(
            f"primitives {frozen.kernel_form_missing} of primitive set "
            f"{frozen.pset.name!r} have no CUDA kernel form; build the "
            'evaluator with backend="plain"')


def evaluate(codes, consts, lengths, X, frozen) -> torch.Tensor:
    """K6: ``(pop, n_points)`` float32 values of ``pop`` prefix programs
    over ``X`` ``(n_args, n_points)``; rows of length 0 give zeros."""
    from .. import kernels
    require_kernel_form(frozen)
    n_args = len(frozen.pset.arguments)
    if X.ndim != 2 or X.shape[0] < n_args:
        raise ValueError(f"X has {X.shape[0]} rows for {n_args} arguments")
    if codes.numel():
        lo, hi = torch.stack(torch.aminmax(codes)).tolist()   # one read
        if lo < 0 or hi >= frozen.n_nodes:
            raise ValueError(f"codes in [{lo}, {hi}] outside the "
                             f"{frozen.n_nodes} nodes of the primitive set")
    tables = frozen.tables(X.device)
    return kernels.launch_gp_interp(codes, consts, lengths, X,
                                    tables["op_kind"], tables["arg_index"])
