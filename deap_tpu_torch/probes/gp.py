"""Roofline probes of the GP stack machine on the card — the port's
counterpart of ``tools/pallas_probe_gp.py``::

    python -m deap_tpu_torch.probes.gp [probe ...] [--device cuda|cpu]

The interpreter's work unit is a token: one opcode read, one dispatch,
one operation on the top of the stack for every point and, for pushes and
binary operations, one stack-row access (K6, ``kernels/gp_interp.cu``).
These probes strip that loop down (P5, ``kernels/probes.cu``) and add the
costs back one at a time, at ``bench_gp.py``'s shape (pop 4096, capacity
64, 1024 points) on full binary trees of exactly 63 tokens:

  noswitch   the bare token loop: a token's constant added to the top
  dispatch   + a switch over the bench set's nine codes (branch j
             computes ``top * (1 + j 1e-7) + const``)
  stackrw    + one stack-row read (even codes) or write (odd codes)
  real63     the port's evaluator, ``gp.make_population_evaluator(...,
             backend="cuda")`` (K6)

``_tb32`` runs 32 trees a block in place of 8 and ``_unrollfull`` unrolls
the token loop over the 63 tokens; K6 has no trees-a-block knob, so
``real63_tb32`` runs the same evaluator as ``real63``.  Each probe reports
ns a token, Mtok/s, the marginal ms of one evaluation and the linearity
witness (the harness of :mod:`deap_tpu_torch.probes`: k and 2k
evaluations, each one's constants shifted by the last one's output);
``stackrw / real63`` in ns a token is ``fraction_of_floor``, the share of
the interpreter's time that the stripped loop demonstrates it needs.
``PROBE_POP`` / ``PROBE_CAP`` / ``PROBE_POINTS`` / ``PROBE_ITERS`` set the
shape and k as in the JAX tool; the result is printed as one JSON line
with the card's name and power limit.

The module also holds ``bench_gp.py``'s toolbox, initial population and
generation (:func:`bench_toolbox`, :func:`bench_initial`,
:func:`bench_generation`) and :func:`comb_trees`, from which
``chip_smoke.py`` and ``kernels/kernel_times.py`` build K6's inputs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import _xla_math, base, gp, kernels, random
from ..algorithms import evaluate_population, var_and
from .._device import resolve_device
from ..gp.pset import Argument, Ephemeral, Primitive, freeze_pset
from ..kernels.peaks import bound_ms
from ..ops import selection
from . import ProbeRun

__all__ = ["LEN", "PROBES", "BENCH_POP", "BENCH_CAP", "BENCH_NPOINTS",
           "BENCH_CXPB", "BENCH_MUTPB", "settings", "bench_pset",
           "bench_toolbox", "bench_initial", "bench_generation",
           "full_binary_trees", "comb_trees", "probe_edges",
           "make_probe_kernel", "probe_bound", "main"]

LEN = 63                     # full binary tree of depth 5
#: bench_gp.py's configuration at full width
BENCH_POP, BENCH_CAP, BENCH_NPOINTS = 4096, 64, 1024
BENCH_CXPB, BENCH_MUTPB = 0.5, 0.1
N_BRANCHES = 9               # the bench set's nodes
PROBES = ["noswitch", "dispatch", "stackrw", "real63", "noswitch_tb32",
          "dispatch_tb32", "real63_tb32", "dispatch_unrollfull",
          "stackrw_unrollfull"]


def settings() -> dict:
    """The shape and k from the environment: ``PROBE_POP`` (4096),
    ``PROBE_CAP`` (64), ``PROBE_POINTS`` (1024), ``PROBE_ITERS`` (32)."""
    env = os.environ
    return {"pop": int(env.get("PROBE_POP", 4096)),
            "cap": int(env.get("PROBE_CAP", 64)),
            "points": int(env.get("PROBE_POINTS", 1024)),
            "iters": int(env.get("PROBE_ITERS", 32))}


def bench_pset():
    """``bench_gp.py``'s primitive set (nine codes after freezing)."""
    ps = gp.PrimitiveSet("MAIN", 1)
    for name in ("add", "sub", "mul", "div", "neg", "cos", "sin"):
        func, arity = gp.safe_ops[name]
        ps.add_primitive(func, arity, name=name)
    ps.add_ephemeral_constant(
        "rand101", lambda keys: random.randint(keys, (), -1, 2).float())
    return ps


def bench_toolbox(dev, pset_kind: str = "bench", per_tree: bool = False,
                  cap: int = BENCH_CAP, n_points: int = BENCH_NPOINTS):
    """``(pset, toolbox, evaluator, initial generator, X)``: bench_gp.py's
    primitive set, data and toolbox on ``dev`` (symbolic regression of
    x^4 + x^3 + x^2 + x on ``n_points`` points of [-1, 1]).  The GP
    operators are registered with their ``rowwise_op`` mark, or with
    ``per_tree`` as the reference examples register them (a lambda over
    one key and one tree, called once a row).  ``"all"`` is a second set
    with every opcode of K6's table (two arguments and a terminal)."""
    if pset_kind == "bench":
        ps = bench_pset()
    else:
        ps = gp.PrimitiveSet("ALL", 2)
        ps.add_terminal(1.0, name="one")
        for name, (f, a) in {**gp.safe_ops, **gp.bool_ops}.items():
            ps.add_primitive(f, a, name=name)
        ps.add_ephemeral_constant(
            "rand101", lambda keys: random.randint(keys, (), -1, 2).float())
    X = torch.linspace(-1, 1, n_points, dtype=torch.float32,
                       device=dev)[None, :]
    x = X[0]
    target = x ** 4 + x ** 3 + x ** 2 + x
    pop_ev = gp.make_population_evaluator(ps, cap)
    gen_mut = gp.make_generator(ps, cap, "full")

    def evaluate_all(genome, skip=None):
        codes, consts, lengths = genome
        if skip is not None:
            # skipped rows run no stack-machine step (length 0)
            lengths = torch.where(skip, 0, lengths)
        out = pop_ev(codes, consts, lengths, X)
        mse = ((out - target[None, :]) ** 2).mean(dim=1)
        return torch.where(torch.isfinite(mse), mse, 1e6)[:, None]

    tb = base.Toolbox()
    tb.register("evaluate_population", evaluate_all)
    if per_tree:
        tb.register("mate", lambda k, a, b: gp.cx_one_point(k, a, b, ps))
        tb.register("mutate", lambda k, t: gp.mut_uniform(
            k, t, lambda kk: gen_mut(kk, 0, 2), ps))
    else:
        tb.register("mate", gp.cx_one_point, pset=ps)
        tb.register("mutate", gp.mut_uniform,
                    expr=lambda kk: gen_mut(kk, 0, 2), pset=ps)
    tb.register("select", selection.sel_tournament, tournsize=3)
    gen_init = gp.make_generator(ps, cap, "half_and_half")
    return ps, tb, pop_ev, gen_init, X


def bench_initial(tb, gen_init, key, n: int):
    """``n`` half-and-half trees of depth 1-3, evaluated."""
    genome = gen_init(random.split(key, n), 1, 3)
    pop = base.Population(genome, base.Fitness.empty(
        n, (-1.0,), device=key.device))
    return evaluate_population(tb, pop)[0]


def bench_generation(tb, key, pop, cxpb: float = BENCH_CXPB,
                     mutpb: float = BENCH_MUTPB):
    """bench_gp.py's generation: select, ``var_and(pairing="halves")``,
    evaluate the rows it touched.  Returns ``(key, offspring, idx)``."""
    key, k_sel, k_var = random.split(key, 3)
    idx = tb.select(k_sel, pop.fitness, pop.size)
    off = var_and(k_var, pop.take(idx), tb, cxpb, mutpb, pairing="halves")
    off, _ = evaluate_population(tb, off)
    return key, off, idx


def full_binary_trees(pset, rng, pop: int, cap: int, device=None):
    """``(codes, consts, lengths)``: ``pop`` prefix programs, each a full
    depth-5 tree of binary primitives over the argument and ephemeral
    leaves — exactly :data:`LEN` tokens — from the numpy generator
    ``rng``, drawn as the JAX tool draws them (the same codes)."""
    nodes = list(freeze_pset(pset).pset.nodes)
    bin_codes = [i for i, n in enumerate(nodes)
                 if isinstance(n, Primitive) and n.arity == 2]
    eph_codes = [i for i, n in enumerate(nodes) if isinstance(n, Ephemeral)]
    leaf_codes = [i for i, n in enumerate(nodes)
                  if isinstance(n, Argument)] + eph_codes

    def one_tree():
        codes, consts = [], []

        def rec(d):
            if d == 0:
                c = leaf_codes[rng.integers(len(leaf_codes))]
                codes.append(c)
                consts.append(float(rng.integers(-1, 2))
                              if c in eph_codes else 0.0)
            else:
                codes.append(bin_codes[rng.integers(len(bin_codes))])
                consts.append(0.0)
                rec(d - 1)
                rec(d - 1)

        rec(5)
        pad = cap - len(codes)
        return codes + [0] * pad, consts + [0.0] * pad

    trees = [one_tree() for _ in range(pop)]
    dev = resolve_device(device)
    codes = torch.tensor(np.array([c for c, _ in trees], np.int32),
                         device=dev)
    consts = torch.tensor(np.array([k for _, k in trees], np.float32),
                          device=dev)
    return codes, consts, torch.full((pop,), LEN, dtype=torch.int32,
                                     device=dev)


def comb_trees(pset, rng, pop: int, cap: int, device=None):
    """``(codes, consts, lengths)``: ``pop`` prefix programs at the
    interpreter's edges, from the numpy generator ``rng``, three shapes
    in turn: a left comb of binary primitives, every leaf pushed before
    the first operator runs (the deepest stack ``cap`` tokens of binary
    operators make), topped with unary primitives to exactly ``cap``
    tokens; the same comb of ternary primitives (``if`` at depth), when
    the set has one; and a right comb (a stack two deep, each operator's
    first operand a leaf).  Leaves are the set's arguments and
    terminals, an ephemeral's constant uniform in [-2, 2)."""
    f = freeze_pset(pset)
    prim = f.is_primitive
    unary, binary, ternary = (np.nonzero(prim & (f.arity == a))[0]
                              for a in (1, 2, 3))
    leaves = np.nonzero(~prim)[0]
    if not len(binary) or not len(leaves):
        raise ValueError("comb trees need a binary primitive and a leaf")
    kinds = ["left", "ternary", "right"] if len(ternary) else ["left",
                                                              "right"]
    codes = np.zeros((pop, cap), np.int32)
    consts = np.zeros((pop, cap), np.float32)
    lengths = np.zeros((pop,), np.int32)

    def leaf():
        c = int(rng.choice(leaves))
        return c, (rng.uniform(-2.0, 2.0) if f.is_ephemeral[c]
                   else f.const_value[c])

    for r in range(pop):
        kind = kinds[r % len(kinds)]
        a = 3 if kind == "ternary" else 2
        k = (cap - 1) // a                     # operators: k a + 1 tokens
        ops = [(int(rng.choice(ternary if a == 3 else binary)), 0.0)
               for _ in range(k)]
        if kind == "right":
            body = [t for op in ops for t in (op, leaf())] + [leaf()]
        else:
            body = ops + [leaf() for _ in range(k * (a - 1) + 1)]
        roots = [(int(rng.choice(unary)), 0.0)
                 for _ in range(cap - len(body))] if len(unary) else []
        toks = roots + body
        lengths[r] = len(toks)
        codes[r, :len(toks)] = [c for c, _ in toks]
        consts[r, :len(toks)] = [v for _, v in toks]
    dev = resolve_device(device)
    return (torch.tensor(codes, device=dev), torch.tensor(consts, device=dev),
            torch.tensor(lengths, device=dev))


def probe_edges(device=None) -> dict:
    """P5's edge inputs by name, each ``(codes, consts, lengths, n_points,
    n_branches)``, from fixed numpy seeds: 4097 full binary trees (no
    multiple of 8 or 32 trees a group), 1000 of them at 1000 points and at
    1 point, random programs at cap 256 shorter than 63 tokens and at cap
    256 up to its whole length, and codes outside ``[0, n_branches)``
    (nine branches and four).  Constants lie in [-1, 1); ``stackrw``'s
    sums overflow to inf on some rows, as on the full trees, and reach no
    NaN."""
    dev = resolve_device(device)
    full = full_binary_trees(bench_pset(), np.random.default_rng(11), 4097,
                             BENCH_CAP, dev)
    part = tuple(t[:1000] for t in full)
    rng = np.random.default_rng(12)

    def programs(cap, max_len, lo, hi):
        return tuple(torch.tensor(a, device=dev) for a in (
            rng.integers(lo, hi, (1000, cap), dtype=np.int32),
            rng.uniform(-1.0, 1.0, (1000, cap)).astype(np.float32),
            rng.integers(0, max_len + 1, 1000, dtype=np.int32)))

    return {
        "pop 4097": (*full, BENCH_NPOINTS, N_BRANCHES),
        "1000 points": (*part, 1000, N_BRANCHES),
        "1 point": (*part, 1, N_BRANCHES),
        "cap 256, lengths below 63": (*programs(256, LEN - 1, 0, 9),
                                      BENCH_NPOINTS, N_BRANCHES),
        "cap 256, lengths up to 256": (*programs(256, 256, 0, 9), 300,
                                       N_BRANCHES),
        "codes outside 9 branches": (*programs(BENCH_CAP, BENCH_CAP, -4, 14),
                                     BENCH_NPOINTS, N_BRANCHES),
        "codes outside 4 branches": (*programs(BENCH_CAP, BENCH_CAP, -4, 14),
                                     BENCH_NPOINTS, 4)}


def _scales(n_branches: int, device) -> torch.Tensor:
    return torch.tensor([np.float32(1.0 + j * 1e-7)
                         for j in range(n_branches)], device=device)


def _probe_gp_plain(codes, consts, lengths, n_points: int, mode: str,
                    tb: int, unroll: bool, n_branches: int) -> torch.Tensor:
    """The stripped token loop, as P5 runs it: trees in blocks of ``tb``,
    each block's stack row starting at zero and carried over its trees in
    order.  No token reads a point's input, so a tree's value is the same
    at every point: computed once and repeated."""
    pop, cap = codes.shape
    nb = -(-pop // tb)
    pad = nb * tb - pop                  # missing trees run no token
    c = torch.nn.functional.pad(codes.long(), (0, 0, 0, pad))
    c = c.clamp(0, n_branches - 1).reshape(nb, tb, cap)
    k = torch.nn.functional.pad(consts, (0, 0, 0, pad)).reshape(nb, tb, cap)
    length = torch.nn.functional.pad(lengths.clamp(0, cap), (0, pad))
    length = torch.full_like(length, LEN) if unroll else length
    length = length.reshape(nb, tb)
    scale = _scales(n_branches, codes.device)[c]
    even = (c & 1) == 0
    stack = torch.zeros(nb, dtype=torch.float32, device=codes.device)
    tops = []
    for i in range(tb):
        top = torch.zeros_like(stack)
        for t in range(cap - 1, -1, -1):
            live = t < length[:, i]
            kt, st = k[:, i, t], scale[:, i, t]
            if mode == "noswitch":
                new = top + kt
            elif mode == "dispatch":
                new = _xla_math.fma(top, st, kt)
            else:
                ev = even[:, i, t]
                new = torch.where(ev, _xla_math.fma(top, st, stack) + kt,
                                  _xla_math.fma(top, st, kt))
                stack = torch.where(live & ~ev, top, stack)
            top = torch.where(live, new, top)
        tops.append(top)
    out = torch.stack(tops, dim=1).reshape(nb * tb)[:pop]
    return out[:, None].expand(pop, n_points).contiguous()


def make_probe_kernel(mode: str, n_branches: int, tb: int, unroll,
                      *, n_points: int):
    """``run(codes, consts, lengths, x) -> (pop, n_points)``: the stripped
    token loop ``mode`` (``noswitch`` / ``dispatch`` / ``stackrw``) over
    ``n_branches`` codes, ``tb`` trees a block, unrolled over 63 tokens
    when ``unroll``.  ``x`` (``(1, 1)``) shifts the constants by ``x *
    1e-30``, so that one evaluation depends on the last.  P5 for CUDA
    tensors, its plain version for CPU tensors.

    The TPU kernel carries its stack from tree to tree over the whole
    grid, which runs in order there; blocks on the card run in no order,
    so the stack carries over the ``tb`` trees of a block only and starts
    at zero (the TPU kernel's starts uninitialised).  ``noswitch`` and
    ``dispatch`` do not touch the stack and equal the TPU kernel's
    function on every tree."""
    if mode not in kernels.PROBE_GP_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= n_branches <= N_BRANCHES:
        raise ValueError(f"n_branches {n_branches} outside [1, {N_BRANCHES}]")

    def run(codes, consts, lengths, x):
        consts = consts + x[0, 0] * 1e-30
        if codes.is_cuda:
            return kernels.launch_probe_gp(
                codes, consts.contiguous(), lengths, n_points=n_points,
                mode=mode, tb=tb, unroll=bool(unroll), n_branches=n_branches)
        return _probe_gp_plain(codes, consts, lengths, n_points, mode, tb,
                               bool(unroll), n_branches)

    return run


def probe_bound(mode: str, codes, n_points: int):
    """``(ms, by)`` of P5 on ``codes``: the tokens' codes and constants,
    the lengths and the output moved once; one float instruction a token
    and point, two on ``stackrw``'s reads (even codes)."""
    pop, cap = codes.shape
    tokens = pop * LEN
    flts = tokens * n_points
    if mode == "stackrw":
        flts += int(((codes[:, :LEN] & 1) == 0).sum()) * n_points
    return bound_ms(8 * pop * cap + 4 * pop + 4 * pop * n_points, flts=flts)


def _marginal_tokens(run: ProbeRun, fn, args, tokens: int, iters: int):
    def step(x):
        return x + fn(*args, x)[:1, :1] * 1e-30

    x0 = torch.ones((1, 1), dtype=torch.float32, device=run.device)
    sec, ratio = run.marginal(step, x0, k=iters)
    return {"ns_per_token": sec / tokens * 1e9,
            "mtok_per_s": tokens / sec / 1e6,
            "eval_ms": sec * 1e3, "linearity": ratio}


def main(argv=None) -> dict:
    """Run the probes; prints and returns the result document."""
    ap = argparse.ArgumentParser(
        prog="python -m deap_tpu_torch.probes.gp",
        description="Roofline probes of the GP stack machine (P5 and K6).")
    ap.add_argument("probes", nargs="*",
                    help=f"probe subset (default: all of {', '.join(PROBES)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.probes if n not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown} (have: {', '.join(PROBES)})")
    cfg = settings()
    pop, cap, npts = cfg["pop"], cfg["cap"], cfg["points"]
    run = ProbeRun(args.device, pop=pop, dim=cap, k_iters=cfg["iters"])
    ps = bench_pset()
    codes, consts, lengths = full_binary_trees(ps, np.random.default_rng(0),
                                               pop, cap, run.device)
    tokens = pop * LEN
    out = {"shape": {"pop": pop, "cap": cap, "points": npts, "len": LEN},
           "platform": run.platform, "device": run.device_line,
           "probes": {}}
    for name in args.probes or PROBES:
        base, *parts = name.split("_")
        tb = next((int(p[2:]) for p in parts if p.startswith("tb")), 8)
        unroll = LEN if name.endswith("unrollfull") else 0
        if base == "real63":
            ev = gp.make_population_evaluator(
                ps, cap, backend="cuda" if run.device.type == "cuda"
                else "plain")
            X = torch.linspace(-1, 1, npts, dtype=torch.float32,
                               device=run.device)[None, :]

            def fn(codes, consts, lengths, x, ev=ev, X=X):
                return ev(codes, consts, lengths, X + x * 1e-30)

            res = _marginal_tokens(run, fn, (codes, consts, lengths), tokens,
                                   cfg["iters"])
            res.update(route=run.route, evaluator="K6 gp_interp"
                       if run.route == "cuda" else "plain interpreter")
        else:
            fn = make_probe_kernel(base, N_BRANCHES, tb, unroll,
                                   n_points=npts)
            res = _marginal_tokens(run, fn, (codes, consts, lengths), tokens,
                                   cfg["iters"])
            b, by = probe_bound(base, codes, npts)
            res.update(route=run.route, tb=tb, unroll=unroll or 1,
                       bound_ms=b, bound_by=by)
        out["probes"][name] = res
        print(f"  {name:20s} {res}", file=sys.stderr, flush=True)
    pr = out["probes"]
    if "real63" in pr and "stackrw" in pr:
        out["fraction_of_floor"] = (pr["stackrw"]["ns_per_token"]
                                    / pr["real63"]["ns_per_token"])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
