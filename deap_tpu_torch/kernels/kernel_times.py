"""Time K1, K2, K3, K5, K6, P1, P2, P3 and P5 of a checkout of this package
on the card.

    python deap_tpu_torch/kernels/kernel_times.py [--root DIR] [--label L]
        [--ablate] [--profile] [--only k1,k2,k3,k5,k6,p1,p1r,p2,p3,p5]
        [--inputs FILE]

Imports ``deap_tpu_torch`` from ``DIR`` (default: the checkout that
holds this file), builds its kernels and prints one JSON line per kernel
and input, CUDA-event milliseconds per launch beside the card's name and
power limit:

* K1 ``launch_vary`` in float32, bfloat16 and int8 at the GA flagship's
  10⁶ × 100 (its knobs) and at the NSGA-II head's 10⁵ × 12 (its knobs:
  cxpb 0.6, mutpb 0.3, sigma 0.1, indpb 1/12; int8 scale 1), there also
  as device time with the launches queued (``device_ms``,
  :func:`queued_ms`): back to back from the host a launch of that size
  is charged its wrapper's Python;
* K2 ``launch_gather_vary`` at 10⁶ × 100 in float32, bfloat16 and int8
  (the flagship's shape and knobs; winners from a random order and
  random positions);
* K3 ``launch_var_or`` in float32, bfloat16 and int8 at 10⁶ × 100 (mu
  0, sigma 0.3, indpb 0.05; int8 scale 5.12) and at the NSGA-II slice's
  10⁵ × 12 (sigma 0.1, indpb 1/12; int8 scale 1), the choices drawn as
  ``var_or`` draws them (cxpb 0.6, mutpb 0.3), with ``device_ms``;
* K5 ``launch_hv3d_sweep`` (128 prefixes a partial) on 8192 uniform
  points at ref (1, 1, 1) and on 10⁵ points of the DTLZ2 front (the unit
  sphere's positive octant) at ref (1.1, 1.1, 1.1), float32 and float64;
* K6 ``launch_gp_interp`` on ``chip_smoke.py``'s phase-13 inputs at
  ``bench_gp.py``'s 4096 × 64 × 1024 (:func:`k6_inputs`): the initial
  population, the one after 20 generations (the same keys), it with
  every other row skipped, the every-opcode set, the comb trees
  (``probes.gp.comb_trees``) at 1024 and 4097 points, the evolved
  population at 4097 points and comb trees of 256 tokens at cap 256,
  with ``device_ms``.  ``--inputs FILE`` reads these tensors from FILE,
  or builds them and writes them there when it does not exist, so that
  a checkout without the input helpers is timed on the same inputs; with
  ``--ablate``, K6 is timed again on copies of the checkout whose
  ``gp_interp.cu`` has one part of the design switched off
  (:data:`ABLATIONS`: points a lane at most 1 / 2 / 4, no folded
  terminals, ``X`` through L1, ``X`` staged even where an SM then holds
  fewer blocks), each built and timed in a process of its own;
* P1 ``launch_probe_stream_copy`` at rows 512, 2048 and 8192 on 2²⁰ ×
  128 float32, with ``copy_`` into a preallocated tensor timed beside
  it, and ``launch_probe_chain24`` (``p1``); P1's
  ``launch_probe_rast_reduce`` at dim 100 on 2²⁰ × 128 float32 drawn
  from [0, 1) (the probe tool's input) and from rastrigin's [-5.12,
  5.12) (``p1r``), with ``device_ms``;
* P2 ``launch_probe_hash_normal`` at 2²⁰ × 128 (seed 12345), with
  ``device_ms``;
* P3 ``launch_probe_lookup``: 2²⁰ queries into a 2²⁰-entry table, at
  random positions and at ``arange`` (every table read coalesced: the
  gap prices L2's random 32-byte reads), beside ``order[pos]``, host-paced
  and ``device_ms``, medians of five readings taken in turns;
* P5 ``launch_probe_gp`` on the GP probe tool's input (4096 full binary
  trees of 63 tokens, cap 64, 1024 points) in every mode at tb 8 and 32,
  the token loop not unrolled and unrolled over 63 tokens, with
  ``device_ms``; and K6 on the same trees (``real63``), so that the
  stripped loop's device time stands beside the interpreter's in one
  run (``fraction_of_floor``: stackrw at tb 8 over K6).

``--ablate`` adds K1 and K2 without mutation (mutpb 0) and as a gather
and copy (cxpb 0 too), K6's parts, and P1's reduce with a part of its
design switched off (:data:`ABLATIONS`, copies of ``probes.cu`` built
and timed as K6's are); ``--profile`` adds K5's
device time by kernel; ``--only`` times a subset (default: all).
Only the wrappers' public signatures are used, so two checkouts can be
timed in one call on one card (parent, change, change, parent).  Needs a
card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

POP, DIM = 1_000_000, 100
KNOBS = (0.9, 0.5, 0.0, 0.3, 0.05)
HEAD_POP, HEAD_DIM = 100_000, 12
HEAD_KNOBS = (0.6, 0.3, 0.0, 0.1, 1.0 / 12)
PROBE_POP, PROBE_LANE = 1 << 20, 128
#: The parts of K6 and P1's reduce that ``--ablate`` switches off (and,
#: last for the reduce, a swizzle it does not keep), each in a copy of
#: the kernel's source: key -> (the source, ((name, ((source text, its
#: replacement), ...)), ...))
ABLATIONS = {
    "k6": ("gp_interp.cu", (
        ("points a lane 1", (("int k = kMaxK;", "int k = 1;"),)),
        ("points a lane 2", (("int k = kMaxK;", "int k = 2;"),)),
        ("points a lane 4", (("int k = kMaxK;", "int k = 4;"),)),
        ("no fold", (("after_push = true;", "after_push = false;"),)),
        ("X through L1", (("if (x_bytes <= (size_t)kXStageMax &&",
                           "if (false && x_bytes <= (size_t)kXStageMax &&"),)),
        ("X staged where it fits", (("xs = staged >= per_sm;",
                                     "xs = true;"),)))),
    "p1r": ("probes.cu", (
        ("the general cosine in every warp",
         (("const bool general = !__all_sync(",
           "const bool general = true || !__all_sync("),)),
        ("every lane computed",
         (("const int vec = (dim + 3) >> 2;", "const int vec = kVec;"),)),
        ("the parent's cosine on every lane",
         (("const bool general = !__all_sync(",
           "const bool general = true || !__all_sync("),
          ("const int vec = (dim + 3) >> 2;", "const int vec = kVec;"),
          ("__device__ __noinline__ float cos_general",
           "__device__ __forceinline__ float cos_general"))),
        ("the general cosine inlined",
         (("__device__ __noinline__ float cos_general",
           "__device__ __forceinline__ float cos_general"),)),
        ("rows swizzled, no bank conflict in the sum",   # an addition:
         (("constexpr int kRastStride = kLanes + 4;",     # word e of row r
           "constexpr int kRastStride = kLanes;"),        # at e ^ (r & 31)
          ("    return tile + r * kRastStride + 4 * c;",
           "    return tile + r * kRastStride + 4 * (c ^ ((r & 31) >> 2));"),
          ("      *at = make_float4(t0, t1, t2, t3);",
           "      if (r & 1) { float s = t0; t0 = t1; t1 = s;"
           " s = t2; t2 = t3; t3 = s; }\n"
           "      if (r & 2) { float s = t0; t0 = t2; t2 = s;"
           " s = t1; t1 = t3; t3 = s; }\n"
           "      *at = make_float4(t0, t1, t2, t3);"),
          ("s = __fadd_rn(s, sum_at[i]);",
           "s = __fadd_rn(s, sum_at[i ^ lane]);"))))),
}


def cuda_ms(fn, reps: int, warm: int) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device milliseconds a call of ``fn`` (kernel launches on the current
    stream), the host's launch work off the clock: the ``reps`` calls are
    queued while the card runs a sleep kernel long enough to cover their
    launching, and CUDA events bracket them on the card.  Timed back to
    back from the host instead (:func:`cuda_ms`), a launch of a few
    microseconds is charged its wrapper's tens of microseconds of
    Python.  The sleep doubles until the queue was full when it ended."""
    import time

    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 100_000
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(8):
        events[0].record()
        torch.cuda._sleep(cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        events[2].record()
        torch.cuda.synchronize()
        if queued_ms < events[0].elapsed_time(events[1]):
            return events[1].elapsed_time(events[2]) / reps
        cycles *= 2
    raise RuntimeError("queued_ms: the launches outran every sleep")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--label", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also print K5's device time by CUDA kernel")
    ap.add_argument("--ablate", action="store_true",
                    help="also time K1 and K2 without mutation and as a "
                    "copy, and K6, P1's reduce and P3 with each part of "
                    "their design off")
    ap.add_argument("--only", default="k1,k2,k3,k5,k6,p1,p1r,p2,p3,p5",
                    help="comma-separated subset of k1, k2, k3, k5, k6, p1, "
                    "p1r, p2, p3, p5")
    ap.add_argument("--inputs", type=Path, default=None,
                    help="K6's inputs: read from this file, or built and "
                    "written there")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times.py needs a CUDA card", file=sys.stderr)
        return 1
    from deap_tpu_torch import kernels, random
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops import hypervolume as H
    from deap_tpu_torch.probes import card_line
    kernels.load()
    card = card_line()
    label = args.label or os.fspath(args.root)
    dev = torch.device("cuda")

    def emit(**fields):
        print(json.dumps({"root": label, "card": card, **fields}),
              flush=True)

    k_g, k_o, k_p, k_s, k_h = random.split(random.PRNGKey(0, device=dev), 5)
    genome = random.uniform(k_g, (POP, DIM), minval=-5.12, maxval=5.12)
    order = torch.argsort(random.uniform(k_o, (POP,))).to(torch.int32)
    pos = random.randint(k_p, (POP,), 0, POP)
    seed = G._seed_from_key(k_s)

    def variants(kn):
        out = {"flagship": torch.tensor(kn, dtype=torch.float32, device=dev)}
        if args.ablate:     # mutpb 0: no draw 3 or erf_inv; then no swap
            out["no mutation"] = torch.tensor(
                (kn[0], 0.0) + kn[2:], dtype=torch.float32, device=dev)
            out["copy"] = torch.tensor(
                (0.0, 0.0) + kn[2:], dtype=torch.float32, device=dev)
        return out

    head = random.uniform(k_h, (HEAD_POP, HEAD_DIM))
    for st, head_st in ((G.GenomeStorage("float32"),) * 2,
                        (G.GenomeStorage("bfloat16"),) * 2,
                        (G.GenomeStorage("int8", 5.12),
                         G.GenomeStorage("int8", 1.0))):
        if not only & {"k1", "k2"}:
            break
        gs = st.to_storage(genome)
        hs = head_st.to_storage(head)
        for variant, kn in variants(KNOBS).items():
            if "k1" in only:
                ms = cuda_ms(lambda: kernels.launch_vary(
                    gs, seed, kn, dim=DIM, dtype=st.dtype, scale=st.scale),
                    reps=20, warm=3)
                emit(kernel="megakernel_vary", dtype=st.dtype,
                     shape=[POP, DIM], knobs=variant, ms=ms)
            if "k2" in only:
                ms = cuda_ms(lambda: kernels.launch_gather_vary(
                    order, pos, gs, seed, kn, dim=DIM, dtype=st.dtype,
                    scale=st.scale), reps=20, warm=3)
                emit(kernel="megakernel_gather_vary", dtype=st.dtype,
                     shape=[POP, DIM], knobs=variant, ms=ms)
        for variant, kn in variants(HEAD_KNOBS).items():
            if "k1" not in only:
                break

            def head_call():
                kernels.launch_vary(hs, seed, kn, dim=HEAD_DIM,
                                    dtype=head_st.dtype, scale=head_st.scale)
            emit(kernel="megakernel_vary", dtype=st.dtype,
                 shape=[HEAD_POP, HEAD_DIM], knobs=f"NSGA-II head {variant}",
                 ms=cuda_ms(head_call, reps=50, warm=5),
                 device_ms=queued_ms(head_call, reps=50, warm=5))
        del gs, hs
    del genome, head
    torch.cuda.empty_cache()

    if "k3" in only:
        k3_times(emit, G, kernels, random.fold_in(k_s, 3), dev)
    if "k6" in only:
        k6_times(emit, kernels, k6_inputs(random.fold_in(k_s, 6), dev,
                                          args.inputs))
    if "p1" in only:
        x = random.uniform(k_o, (PROBE_POP, PROBE_LANE))
        into = torch.empty_like(x)
        for rows in (512, 2048, 8192):
            ms = cuda_ms(lambda: kernels.launch_probe_stream_copy(
                x, rows=rows), reps=20, warm=3)
            lib = cuda_ms(lambda: into.copy_(x), reps=20, warm=3)
            emit(kernel="probe_stream_copy", rows=rows,
                 shape=[PROBE_POP, PROBE_LANE], ms=ms, copy_ms=lib,
                 tb_per_s=2 * x.numel() * 4 / ms / 1e9)
        ms = cuda_ms(lambda: kernels.launch_probe_chain24(x), reps=20,
                     warm=3)
        emit(kernel="probe_chain24", shape=[PROBE_POP, PROBE_LANE], ms=ms)
        del x, into
        torch.cuda.empty_cache()
    if "p1r" in only:
        for name, lo, hi in (("uniform [0, 1)", 0.0, 1.0),
                             ("uniform [-5.12, 5.12)", -5.12, 5.12)):
            x = random.uniform(k_o, (PROBE_POP, PROBE_LANE), minval=lo,
                               maxval=hi)

            def p1r_call():
                return kernels.launch_probe_rast_reduce(x, dim=DIM)
            emit(kernel="probe_rast_reduce", input=name, dim=DIM,
                 shape=[PROBE_POP, PROBE_LANE],
                 ms=cuda_ms(p1r_call, reps=20, warm=3),
                 device_ms=queued_ms(p1r_call, reps=20, warm=3))
            del x
        torch.cuda.empty_cache()
    if "p3" in only:
        p3_times(emit, kernels, random.fold_in(k_p, 3), dev)
    if args.ablate:
        for key in ("k6", "p1r"):
            if key in only:
                ablations(args.root.resolve(), label, key, args.inputs)
    if "p2" in only:
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)

        def p2_call():
            return kernels.launch_probe_hash_normal(seed, PROBE_POP)
        emit(kernel="probe_hash_normal", shape=[PROBE_POP, PROBE_LANE],
             ms=cuda_ms(p2_call, reps=20, warm=3),
             device_ms=queued_ms(p2_call, reps=20, warm=3))
        torch.cuda.empty_cache()
    if "p5" in only:
        p5_times(emit, kernels, dev)
    if "k5" not in only:
        return 0

    k_u, k_f = random.split(k_h)
    sphere = random.uniform(k_f, (100_000, 3)) + 1e-3
    sphere = sphere / sphere.norm(dim=1, keepdim=True)
    for name, pts, ref in (
            ("8192 uniform", random.uniform(k_u, (8192, 3)), (1.0,) * 3),
            ("1e5 DTLZ2 front", sphere, (1.1,) * 3)):
        for dtype in (torch.float32, torch.float64):
            clipped, r = H._as_points(pts.to(dtype), ref)
            _, ys, zr, dz, width = H._hv3d_prep(clipped, r)
            ys, zr, width, dz = (t.contiguous() for t in (ys, zr, width, dz))
            ref_y = float(torch.tensor(ref, dtype=dtype)[1])
            ms = cuda_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128), reps=10, warm=2)
            by = _device_ms(lambda: kernels.launch_hv3d_sweep(
                ys, zr, width, dz, ref_y, threads=128)) if args.profile \
                else None
            emit(kernel="hv3d_sweep", input=name, n=pts.shape[0],
                 dtype=str(dtype).split(".")[1], ms=ms, device_ms_by=by)
    return 0


def k3_times(emit, G, kernels, key, dev) -> None:
    """K3 at the flagship's and the NSGA-II slice's shapes, three types,
    host-paced and with the launches queued."""
    import torch
    from deap_tpu_torch import random
    for (n, dim, knobs, scale) in ((POP, DIM, (0.0, 0.3, 0.05), 5.12),
                                   (HEAD_POP, HEAD_DIM,
                                    (0.0, 0.1, 1.0 / 12), 1.0)):
        k_g, k_d = random.split(random.fold_in(key, dim))
        genome = random.uniform(k_g, (n, dim), minval=-scale, maxval=scale)
        ia, i2, code, seed = G._var_or_draws(k_d, n, n, 0.6, 0.3)
        kn = torch.tensor(knobs, dtype=torch.float32, device=dev)
        for st in (G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
                   G.GenomeStorage("int8", scale)):
            gs = st.to_storage(genome)

            def call():
                kernels.launch_var_or(gs, ia, i2, code, seed, kn, dim=dim,
                                      dtype=st.dtype, scale=st.scale)
            emit(kernel="megakernel_var_or", dtype=st.dtype, shape=[n, dim],
                 ms=cuda_ms(call, reps=20, warm=3),
                 device_ms=queued_ms(call, reps=20, warm=3))
            del gs
        del genome
        torch.cuda.empty_cache()


def p5_times(emit, kernels, dev) -> None:
    """P5 in every form on the GP probe tool's input, and K6 on the same
    trees, host-paced and with the launches queued."""
    import numpy as np
    import torch
    from deap_tpu_torch.probes import gp as P
    ps = P.bench_pset()
    codes, consts, lengths = P.full_binary_trees(
        ps, np.random.default_rng(0), P.BENCH_POP, P.BENCH_CAP, dev)
    shape = [P.BENCH_POP, P.BENCH_CAP, P.BENCH_NPOINTS]
    device = {}
    for mode in ("noswitch", "dispatch", "stackrw"):
        for tb in (8, 32):
            for unroll in (False, True):
                def call():
                    return kernels.launch_probe_gp(
                        codes, consts, lengths, n_points=P.BENCH_NPOINTS,
                        mode=mode, tb=tb, unroll=unroll, n_branches=9)
                device[mode, tb, unroll] = queued_ms(call, reps=20, warm=3)
                emit(kernel="probe_gp", mode=mode, tb=tb,
                     unroll=63 if unroll else 1, shape=shape,
                     ms=cuda_ms(call, reps=20, warm=3),
                     device_ms=device[mode, tb, unroll])
    t = ps.freeze().tables(dev)
    X = torch.linspace(-1, 1, P.BENCH_NPOINTS, device=dev)[None, :]

    def real63():
        return kernels.launch_gp_interp(codes, consts, lengths, X,
                                        t["op_kind"], t["arg_index"])
    k6 = queued_ms(real63, reps=20, warm=3)
    emit(kernel="gp_interp", input="real63 (the probe's trees)", shape=shape,
         ms=cuda_ms(real63, reps=20, warm=3), device_ms=k6,
         fraction_of_floor=device["stackrw", 8, False] / k6)


def k6_inputs(key, dev, path=None) -> dict:
    """K6's inputs by name, each ``(codes, consts, lengths, X, op_kind,
    arg_index)`` on ``dev``: read from ``path`` when it exists, else built
    with ``probes.gp``'s bench helpers (the keys of ``chip_smoke.py``'s
    phase 13) and written to ``path`` when one is given."""
    import numpy as np
    import torch
    if path is not None and Path(path).exists():
        return {k: tuple(t.to(dev) for t in v)
                for k, v in torch.load(path).items()}
    from deap_tpu_torch import random
    from deap_tpu_torch.probes import gp as P
    k_gp = random.split(random.fold_in(random.PRNGKey(0, device=dev), 3),
                        3)[1]
    k_init, k_run, _ = random.split(k_gp, 3)
    ps, tb, _, gen_init, X = P.bench_toolbox(dev)
    pop = pop0 = P.bench_initial(tb, gen_init, k_init, P.BENCH_POP)
    k = k_run
    for _ in range(20):                   # chip_smoke.py's 2 N generations
        k, pop, _ = P.bench_generation(tb, k, pop)
    codes, consts, lengths = pop.genome
    half = torch.where(torch.arange(P.BENCH_POP, device=dev) % 2 == 0, 0,
                       lengths)
    ps_all, _, _, gen_all, _ = P.bench_toolbox(dev, "all")

    def two_args(n):
        return torch.stack([torch.linspace(-1, 1, n, device=dev),
                            torch.linspace(3, -2, n, device=dev)])
    comb = P.comb_trees(ps_all, np.random.default_rng(8), P.BENCH_POP,
                        P.BENCH_CAP, dev)
    comb256 = P.comb_trees(ps_all, np.random.default_rng(9), P.BENCH_POP,
                           256, dev)
    x4097 = torch.linspace(-1, 1, 4097, device=dev)[None, :]
    sets = {
        "initial": (ps, pop0.genome, X),
        "evolved": (ps, pop.genome, X),
        "skipped": (ps, (codes, consts, half), X),
        "all_ops": (ps_all, gen_all(random.split(key, P.BENCH_POP), 2, 6),
                    two_args(P.BENCH_NPOINTS)),
        "comb": (ps_all, comb, two_args(P.BENCH_NPOINTS)),
        "comb 4097": (ps_all, comb, two_args(4097)),
        "evolved 4097": (ps, pop.genome, x4097),
        "comb cap 256": (ps_all, comb256, two_args(P.BENCH_NPOINTS))}
    out = {}
    for name, (pset, genome, x) in sets.items():
        t = pset.freeze().tables(dev)
        out[name] = (*(g.contiguous() for g in genome), x.contiguous(),
                     t["op_kind"], t["arg_index"])
    if path is not None:
        torch.save({k: tuple(t.cpu() for t in v) for k, v in out.items()},
                   path)
    return out


def k6_times(emit, kernels, inputs: dict) -> None:
    """K6 on each input, host-paced and with the launches queued."""
    for name, (c, k_, l_, x, op_kind, arg_index) in inputs.items():
        def call():
            return kernels.launch_gp_interp(c, k_, l_, x, op_kind, arg_index)
        emit(kernel="gp_interp", input=name,
             shape=[*c.shape, x.shape[1]], tokens=int(l_.sum().item()),
             ms=cuda_ms(call, reps=20, warm=3),
             device_ms=queued_ms(call, reps=20, warm=3))


def p3_times(emit, kernels, key, dev) -> None:
    """P3 at 2²⁰ queries into a 2²⁰-entry table, random positions and
    ``arange``, beside ``order[pos]``: host-paced and device ms, the
    median of five readings of each, kernel and library call in turns."""
    import statistics

    import torch
    from deap_tpu_torch import random
    k_o, k_p = random.split(key)
    order = torch.argsort(random.uniform(k_o, (PROBE_POP,))).to(torch.int32)
    for name, pos in (
            ("random", random.randint(k_p, (PROBE_POP,), 0, PROBE_POP)),
            ("arange", torch.arange(PROBE_POP, dtype=torch.int32,
                                    device=dev))):
        calls = {"": lambda: kernels.launch_probe_lookup(order, pos),
                 "library_": lambda: order[pos]}
        reads = {f"{k}{t}": [] for k in calls for t in ("ms", "device_ms")}
        for _ in range(5):
            for k, fn in calls.items():
                reads[f"{k}ms"].append(cuda_ms(fn, reps=20, warm=3))
                reads[f"{k}device_ms"].append(queued_ms(fn))
        emit(kernel="probe_lookup", positions=name, queries=PROBE_POP,
             table=PROBE_POP, **{k: statistics.median(v)
                                 for k, v in reads.items()}, readings=reads)


def ablations(root: Path, label: str, key: str, inputs=None) -> None:
    """``key``'s kernel with each part of :data:`ABLATIONS` switched off:
    a copy of ``root``'s package under the build directory whose source
    has that entry's edits, built and timed by this script in a process
    of its own (``--only key``; K6 on ``inputs``, written first when it
    does not exist)."""
    source, table = ABLATIONS[key]
    build_dir = Path(__file__).resolve().parent.parent / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        extra = []
        if key == "k6":
            extra = ["--inputs", str(inputs or Path(tmp) / "k6_inputs.pt")]
        for name, edits in table:
            copy = Path(tmp) / "root"
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(root / "deap_tpu_torch", copy / "deap_tpu_torch",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            src = copy / "deap_tpu_torch" / "kernels" / source
            text = src.read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{src}: no single {old!r} to switch "
                                       "off")
                text = text.replace(old, new)
            src.write_text(text)
            subprocess.run([sys.executable, __file__, "--root", str(copy),
                            "--label", f"{label} {name}", "--only", key,
                            *extra], check=True)


def _device_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by CUDA kernel (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


if __name__ == "__main__":
    sys.exit(main())
