"""Genetic programming — the PyTorch counterpart of ``deap_tpu/gp``.

A program is a fixed-capacity prefix token array ``(codes, consts,
lengths)``, generated (:mod:`.generate`) and varied (:mod:`.variation`)
by index arithmetic over a leading row axis with one key per row, and
evaluated by a stack machine (:mod:`.interp`): the CUDA kernel K6
(:mod:`.interp_cuda`) on a CUDA tensor, the plain PyTorch interpreter on
the CPU.

The protected primitives of the reference's examples are in
:data:`safe_ops`, the boolean ones in :data:`bool_ops`.  ``sin``,
``cos``, ``protected_log``, ``protected_sqrt`` and ``logistic`` are
XLA's CPU forms (:mod:`deap_tpu_torch._xla_math`), so the port's values
equal the JAX package's on the CPU; ``torch.sin``/``torch.cos`` differ
from them in the last bit on a few percent of inputs and have no kernel
form.

HARM-GP (:mod:`.harm`), ADFs (:mod:`.adf`) and control-flow routines
(:mod:`.routine`) sit on top; the ADF and routine interpreters are
plain PyTorch on every device, as the JAX package runs them on XLA and
never in its kernel.
"""

import numpy as np
import torch

from .._xla_math import cos, exp as _exp, log as _log, sin, sqrt as _sqrt
from .pset import (Primitive, Terminal, Ephemeral, Argument,  # noqa: F401
                   PrimitiveSetTyped, PrimitiveSet, FrozenPSet, freeze_pset)
from .interp import (make_evaluator, make_population_evaluator,  # noqa: F401
                     compile_tree, run_stack_machine)
from .interp_cuda import KernelFormUnavailable  # noqa: F401
from .generate import (make_generator, gen_full, gen_grow,  # noqa: F401
                       gen_half_and_half)
from .variation import (cx_one_point, cx_one_point_leaf_biased,  # noqa: F401
                        mut_uniform, mut_node_replacement, mut_ephemeral,
                        mut_insert, mut_shrink, static_limit, subtree_bounds,
                        node_depths, tree_height, cx_semantic, mut_semantic)
from .tree import to_string, from_string, graph  # noqa: F401
from .harm import harm  # noqa: F401
from .adf import (make_adf_evaluator,  # noqa: F401
                  make_adf_population_evaluator, compile_adf)
from .routine import make_routine_interpreter  # noqa: F401

compileADF = compile_adf
compile = compile_tree
genFull = gen_full
genGrow = gen_grow
genHalfAndHalf = gen_half_and_half
cxOnePoint = cx_one_point
cxOnePointLeafBiased = cx_one_point_leaf_biased
mutUniform = mut_uniform
mutNodeReplacement = mut_node_replacement
mutEphemeral = mut_ephemeral
mutInsert = mut_insert
mutShrink = mut_shrink
staticLimit = static_limit
cxSemantic = cx_semantic
mutSemantic = mut_semantic

_EPS = float(np.float32(1e-9))


def protected_div(left, right):
    """Protected division -> 1 where ``|right| <= 1e-9`` (float32), a true
    division elsewhere."""
    ok = right.abs() > _EPS
    return torch.where(ok, torch.div(left, torch.where(ok, right, 1.0)), 1.0)


def protected_log(x):
    """``log(max(|x|, 1e-9))`` with XLA's float32 ``log``."""
    return _log(torch.clamp(x.abs(), min=_EPS))


def protected_sqrt(x):
    """``sqrt(|x|)``, correctly rounded."""
    return _sqrt(x.abs())


def logistic(x):
    """``1 / (1 + exp(-x))`` with XLA's float32 ``exp`` (the form XLA's
    CPU backend gives ``jax.nn.sigmoid``)."""
    return torch.div(torch.ones_like(x), 1.0 + _exp(-x))


def _b(x):
    return x != 0


def b_and(a, b):
    return (_b(a) & _b(b)).to(a.dtype)


def b_or(a, b):
    return (_b(a) | _b(b)).to(a.dtype)


def b_xor(a, b):
    return (_b(a) ^ _b(b)).to(a.dtype)


def b_not(a):
    return (~_b(a)).to(a.dtype)


def b_if_then_else(c, a, b):
    return torch.where(_b(c), a, b)


#: Boolean primitives on the float stack (0.0 = false).
bool_ops = {
    "and_": (b_and, 2),
    "or_": (b_or, 2),
    "xor_": (b_xor, 2),
    "not_": (b_not, 1),
    "if_then_else": (b_if_then_else, 3),
}

safe_ops = {
    "add": (torch.add, 2),
    "sub": (torch.subtract, 2),
    "mul": (torch.multiply, 2),
    "div": (protected_div, 2),
    "neg": (torch.negative, 1),
    "cos": (cos, 1),
    "sin": (sin, 1),
    "log": (protected_log, 1),
    "sqrt": (protected_sqrt, 1),
    "lf": (logistic, 1),
}
