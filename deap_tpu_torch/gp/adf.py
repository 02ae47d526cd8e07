"""Automatically Defined Functions — the PyTorch counterpart of
``deap_tpu/gp/adf.py`` (reference ``addADF`` and ``compileADF``).

An individual is a tuple of ``(codes, consts, lengths)`` triples, one a
primitive set: the main set first, then the ADF sets it references
(transitively), the order ``compileADF`` expects.  The evaluator is a
nested stack machine: where pset ``i``'s machine meets an ADF node, the
callee set's machine runs on that individual's ADF tree with the popped
argument rows as its input.  ADF references are acyclic (a set can only
name sets built before it); a cycle raises ``ValueError``.

The JAX package runs ADF programs only on its XLA interpreter, never in
its kernel, so the port runs them on its plain stack machine
(:func:`deap_tpu_torch.gp.interp.run_stack_machine`) on every device.
That machine computes every node's branch at every token for every
tree; an ADF node's branch is a whole nested run, so the port runs it
only on the trees whose token there is that node (the same values: a
tree's result depends on its own inputs alone), which costs one read on
the host a token and an ADF node.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .interp import run_stack_machine
from .pset import Primitive, PrimitiveSetTyped, freeze_pset

__all__ = ["make_adf_evaluator", "make_adf_population_evaluator",
           "compile_adf"]


def _build(psets: Sequence[PrimitiveSetTyped], cap: int) -> Callable:
    """``evaluate(trees, X) -> (pop, n_points)``: the main set's machine
    over a population, ``trees`` a tuple of ``(codes (pop, cap), consts
    (pop, cap), lengths (pop,))`` per set and ``X`` ``(n_args,
    n_points)`` or ``(pop, n_args, n_points)``."""
    fs = [freeze_pset(p) for p in psets]
    name_to_idx = {f.pset.name: j for j, f in enumerate(fs)}
    cache: dict = {}
    building: list = []

    def build(i: int) -> Callable:
        if i in cache:
            return cache[i]
        if i in building:
            chain = " -> ".join(fs[j].pset.name for j in building + [i])
            raise ValueError(
                f"cyclic ADF reference: {chain}; ADF references must be "
                "acyclic")
        building.append(i)
        f = fs[i]
        # resolve the callees first, so a cycle raises here
        subs = {code: (build(name_to_idx[node.name]),
                       len(fs[name_to_idx[node.name]].pset.ins))
                for code, node in enumerate(f.pset.nodes)
                if isinstance(node, Primitive) and node.name in name_to_idx}

        def evaluate_i(trees, X):
            codes, consts, lengths = trees[i]

            def call(sub, n_args):
                def run(rows, args):
                    part = tuple(tuple(x[rows] for x in t) for t in trees)
                    return sub(part, args[:, :n_args])
                return run

            calls = {code: call(sub, n) for code, (sub, n) in subs.items()}
            return run_stack_machine(codes, consts, lengths, X, f, cap,
                                     calls)

        building.pop()
        cache[i] = evaluate_i
        return evaluate_i

    return build(0)


def make_adf_evaluator(psets: Sequence[PrimitiveSetTyped],
                       cap: int) -> Callable:
    """``evaluate(trees, X) -> (n_points,)`` for one ADF program:
    ``psets`` the main set first, then the ADF sets; ``trees`` a matching
    tuple of ``(codes (cap,), consts (cap,), length)`` triples; ``X``
    ``(n_main_args, n_points)``."""
    ev = _build(psets, cap)

    def evaluate(trees, X):
        one = tuple((torch.as_tensor(c, device=X.device)[None],
                     torch.as_tensor(k, device=X.device)[None],
                     torch.as_tensor(l, device=X.device).reshape(1))
                    for c, k, l in trees)
        return ev(one, X)[0]

    return evaluate


def make_adf_population_evaluator(psets, cap: int) -> Callable:
    """``evaluate_pop(stacked_trees, X) -> (pop, n_points)``: the tree
    triples carry a leading population axis."""
    return _build(psets, cap)


def compile_adf(trees, psets, cap: int | None = None) -> Callable:
    """Host-facing parity with reference ``compileADF``: a callable over
    the main set's arguments (all scalars, or 1-D values of one length),
    on the trees' device."""
    trees = tuple(tuple(torch.as_tensor(x) for x in t) for t in trees)
    cap = cap or trees[0][0].shape[-1]
    ev = make_adf_evaluator(psets, cap)
    dev = trees[0][0].device

    def func(*args):
        if args:
            ndims = {torch.as_tensor(a).ndim for a in args}
            if len(ndims) > 1:
                raise TypeError(
                    "compile_adf arguments must be all scalars or all "
                    f"equal-length 1-D arrays, got ndims {sorted(ndims)}")
            scalar = ndims == {0}
            cols = [torch.atleast_1d(torch.as_tensor(
                a, dtype=torch.float32, device=dev)) for a in args]
            lengths = {c.shape[0] for c in cols}
            if len(lengths) > 1:
                raise TypeError(
                    "compile_adf array arguments must share one length, "
                    f"got lengths {sorted(lengths)}")
            X = torch.stack(cols)
        else:
            scalar = False
            X = torch.zeros((1, 1), dtype=torch.float32, device=dev)
        out = ev(trees, X)
        return float(out[0]) if scalar else out

    return func
