"""GP tree evaluation — the PyTorch counterpart of ``deap_tpu/gp/interp.py``.

A tree is ``(codes, consts, length)`` in prefix order at a fixed
capacity.  The stack machine walks the tokens right to left, pushes
terminal values and applies each primitive to the ``arity`` values on
top of the stack (its leftmost child on top), for all sample points at
once.

:func:`run_stack_machine` is the plain version over a batch of trees:
the JAX function's scan as a Python loop over the ``cap`` tokens, every
primitive computed for every tree at each step and the tree's own picked
by its code (what ``lax.switch`` does under ``vmap``), with the same
active mask, clamped stack rows and result row.  On the card
:func:`make_population_evaluator` runs the CUDA kernel K6 instead
(:mod:`deap_tpu_torch.gp.interp_cuda`), which walks only ``length``
tokens, decoded once per tree, with the stack in shared memory; both
give zeros for a row of length 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from .interp_cuda import evaluate, require_kernel_form
from .pset import Argument, Primitive, freeze_pset

__all__ = ["run_stack_machine", "make_evaluator", "make_population_evaluator",
           "compile_tree", "PopulationEvaluator"]


def run_stack_machine(codes, consts, lengths, X, frozen, cap: int):
    """The plain interpreter: ``(pop, n_points)`` values of the trees
    ``codes``/``consts`` ``(pop, cap)`` with ``lengths`` ``(pop,)`` over
    ``X`` ``(n_args, n_points)``."""
    f = freeze_pset(frozen)
    t = f.tables(X.device)
    pop, n_points = codes.shape[0], X.shape[1]
    max_arity = max(f.max_arity, 1)
    rows = torch.arange(pop, device=X.device)
    lanes = torch.arange(max_arity, device=X.device)
    stack = torch.zeros((pop, cap + 1, n_points), dtype=X.dtype,
                        device=X.device)
    sp = torch.zeros((pop,), dtype=torch.int64, device=X.device)
    nodes = f.pset.nodes
    leaf_const = torch.as_tensor(~f.is_primitive & ~f.is_argument,
                                 device=X.device)
    for pos in range(cap - 1, -1, -1):
        c = codes[:, pos].long().clamp(0, f.n_nodes - 1)
        const = consts[:, pos]
        active = pos < lengths
        arg_rows = torch.clamp(sp[:, None] - 1 - lanes[None, :], 0, cap)
        args = stack[rows[:, None], arg_rows]       # (pop, max_arity, pts)
        res = torch.where(leaf_const[c][:, None], const[:, None].to(X.dtype),
                          torch.zeros((), dtype=X.dtype, device=X.device))
        for code, node in enumerate(nodes):
            if isinstance(node, Primitive):
                val = node.func(*(args[:, j] for j in range(node.arity)))
            elif isinstance(node, Argument):
                val = X[node.index][None, :]
            else:
                continue
            res = torch.where((c == code)[:, None], val, res)
        new_sp = torch.where(active, sp - t["arity"][c] + 1, sp)
        row = torch.where(active, torch.clamp(new_sp - 1, 0, cap - 1), cap)
        stack[rows, row] = res
        sp = new_sp
    return stack[rows, torch.clamp(sp - 1, 0, cap - 1)]


class PopulationEvaluator:
    """``evaluate_pop(codes (pop, cap), consts (pop, cap), lengths (pop,),
    X (n_args, n_points)) -> (pop, n_points)``.

    ``backend`` is what was asked for; :meth:`resolve` names the route a
    call with ``X`` takes (``"cuda"``: K6, ``"plain"``: the plain
    interpreter), and ``last_backend`` is the route of the last call."""

    def __init__(self, pset, cap: int, backend: str):
        self.frozen = freeze_pset(pset)
        self.cap = cap
        self.backend = backend
        self.last_backend = None
        if backend == "cuda":
            require_kernel_form(self.frozen)

    def resolve(self, X) -> str:
        if self.backend == "plain":
            return "plain"
        if self.backend == "cuda" and not X.is_cuda:
            raise ValueError('backend="cuda" needs CUDA tensors '
                             f"(X is on {X.device})")
        return "cuda" if X.is_cuda else "plain"

    def __call__(self, codes, consts, lengths, X):
        route = self.resolve(X)
        if route == "cuda":
            out = evaluate(codes.to(torch.int32).contiguous(),
                           consts.to(torch.float32).contiguous(),
                           lengths.to(torch.int32).contiguous(),
                           X.to(torch.float32).contiguous(), self.frozen)
        else:
            out = run_stack_machine(codes, consts, lengths, X, self.frozen,
                                    self.cap)
        self.last_backend = route
        return out


def make_population_evaluator(pset, cap: int, *, backend: str = "auto",
                              block_trees: int = 8) -> PopulationEvaluator:
    """The population evaluator.  ``backend="auto"`` takes K6 when ``X``
    is a CUDA tensor and the plain interpreter when it is on the CPU;
    ``"cuda"`` insists on K6 and ``"plain"`` on the plain interpreter.
    A primitive set with a primitive outside the op-kind table raises
    :class:`~deap_tpu_torch.gp.interp_cuda.KernelFormUnavailable` on a
    CUDA request (at construction for ``"cuda"``, at the call for
    ``"auto"``): nothing switches to the plain interpreter unasked.

    ``block_trees`` is the JAX package's trees per Pallas grid step; it
    is validated as there (``ValueError`` below 1) and otherwise
    ignored: K6's warps take items of one tree and 256 of its points in
    turn (``kernels/gp_interp.cu``), so it has no tree blocking to
    tune."""
    if backend not in ("auto", "plain", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if block_trees < 1:
        raise ValueError(f"block_trees must be >= 1, got {block_trees}")
    return PopulationEvaluator(pset, cap, backend)


def make_evaluator(pset, cap: int) -> Callable:
    """``evaluate(codes (cap,), consts (cap,), length, X) -> (n_points,)``
    for one tree, with the plain interpreter."""
    f = freeze_pset(pset)

    def evaluate(codes, consts, length, X):
        length = torch.as_tensor(length, device=X.device).reshape(1)
        return run_stack_machine(codes[None], consts[None], length, X, f,
                                 cap)[0]

    return evaluate


def compile_tree(tree, pset, cap: int | None = None) -> Callable:
    """Host-facing parity with reference ``gp.compile``: a callable
    ``f(*args)`` evaluating the tree on scalars or 1-D values (args in
    the set's argument order), on the tree's device."""
    codes, consts, length = (torch.as_tensor(x) for x in tree)
    cap = cap or codes.shape[-1]
    ev = make_evaluator(pset, cap)

    def func(*args):
        if args:
            scalar = all(torch.as_tensor(a).ndim == 0 for a in args)
            X = torch.stack([torch.atleast_1d(torch.as_tensor(
                a, dtype=torch.float32, device=codes.device)) for a in args])
        else:
            scalar = False
            X = torch.zeros((1, 1), dtype=torch.float32, device=codes.device)
        out = ev(codes, consts, length, X)
        return float(out[0]) if scalar else out

    return func
