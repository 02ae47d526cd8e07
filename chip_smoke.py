#!/usr/bin/env python3
"""Drive deap_tpu_torch on one NVIDIA card and check it, phase by phase.

    python3 chip_smoke.py

1. build   — compile the port's CUDA kernels from the checkout's source
             and bind them;
2. K1      — ``megakernel_vary`` against its plain PyTorch version on the
             card, pop 1e6 x dim 100, float32 / bfloat16 / int8 storage;
3. K2      — ``megakernel_gather_vary`` (one warp a mating pair) against
             ``index_select`` plus the plain variation, same sizes, bit
             for bit, its time beside its byte bound;
4. reference — one whole fused generation on a small input: the card's
             output against the CPU path's, bit for bit; then, bit for
             bit card against CPU, an ``ea_step(reevaluate_all=True)``
             generation on the xla engine (pop 1024 x 100) and
             ``mut_gaussian`` on a float32 genome (4096 x 100: ``mu`` 0
             and 0.5 as Python numbers, ``mu`` and ``sigma`` as tensors)
             and on a bfloat16 one;
5. main path — ``ea_simple`` with the megakernel engine on rastrigin, pop
             1e6 x dim 100 float32, NGEN and 2*NGEN generations, five
             pairs (median marginal time per generation), best fitness
             must fall; then
             the serving step (``ea_step`` with a live mask) for a few
             generations.  Launch counts are zeroed before each of the two
             and read after: each kernel must have run on its path.
6. K3      — ``megakernel_var_or`` against ``index_select`` plus the
             plain OR-choice variation: lambda 1e6 x dim 100 in float32 /
             bfloat16 / int8, and the NSGA-II slice's 1e5 x 12 (device
             time with the launches queued beside the host-paced one);
             then dims 1, 3, 12, 100 and 1000 with lambda != mu;
7. K4      — ``rows_dominate_counts`` against the plain counts, C = 1024
             and C = n rows against n = 2e5 DTLZ2 points of a real pool
             (with -inf sentinel rows and duplicated points), then
             SPEA2's strength form ``(-w, -w)`` at C = n = 2e5 on ZDT1
             (m = 2) and DTLZ2 values (+inf rows, duplicates): equal
             counts;
8. reference — one NSGA-II generation at mu = lambda = 1024: the card's
             ``var_or`` offspring against the CPU's bit for bit, then
             ``sel_nsga2`` on the card, given the CPU pool's values,
             against the CPU's indices, and the ``ea_step`` head's
             offspring bit for bit;
9. main path — NSGA-II ``ea_mu_plus_lambda`` (DTLZ2, 3 objectives, 12
             variables, mu = lambda = 1e5, ``sel_nsga2(nd="peel",
             front_chunk=1024)``, megakernel engine): N and 2N
             generations, three pairs (median marginal time per
             generation), K3 once and K4 at least once per generation,
             and DTLZ2's distance to the front (mean of |f| - 1) must
             fall; an untimed replay of the N-generation run counts the
             fronts peeled per generation;
10. the NSGA-II ``ea_step`` head (``sel_nsga2`` then K1): K1 against its
             plain version on one generation's parents (1e5 x 12, the
             head's knobs, float32 / bfloat16 / int8; its device time
             with the launches queued beside the host-paced one), then a
             few generations at full width with K1's launches counted;
11. reference — one GP bench generation (``bench_gp.py``: symbolic
             regression, pop 256 here) on the card against the CPU path:
             selection indices equal, trees bitwise after ``var_and``,
             MSE within rtol 1e-5; then the same generation on the card
             with the operators registered per tree, as the reference
             examples register them (``lambda k, t: gp.mut_uniform(k, t,
             expr, pset)``), against the CPU's;
12. main path — ``bench_gp.py``'s generation at full width (pop 4096,
             tree capacity 64, 1024 points): N = 10 and 2N generations,
             three pairs (median marginal time per generation), K6 once
             per generation, the best MSE must fall, mean tree length at
             the start and the end; then ``ea_simple`` on the same
             toolbox for a few generations with K6's launches counted;
13. K6        — ``gp_interp`` against the plain interpreter, bitwise, on
             the initial population, the population after 2N generations,
             the same with every other row skipped, and a set with every
             opcode of the table (4096 x 64 x 1024, 2 arguments); then
             comb trees of exactly 64 tokens at the deepest stack (``if``
             at depth) at 1024, 1, 1000 and 4097 points, the evolved
             population at 4097 points, a single tree, every row
             skipped, and comb trees of 256 tokens at cap 256 at 1024
             and 4097 points (device time with the launches queued
             beside each);
14. reference — one generation of ``bench_nsga2.py`` as published (SBX,
             polynomial mutation, ``sel_nsga2(nd="auto")``) at POP 1024 on
             the card against the CPU path, for DTLZ2 (A) and ZDT1 (B):
             offspring bitwise, selection indices equal on the CPU pool's
             values, grid / staircase ranks equal to the count peel's;
15. main path A — ``bench_nsga2.py`` with ``BENCH_PROBLEM=dtlz2`` at POP
             1e5 (pool 2e5, 3 objectives, 12 variables, grid ranks): N = 3
             and 2N generations, three pairs (median marginal time per
             generation), then ``toolbox.hypervolume`` of the final
             population at ref (1.1, 1.1, 1.1): K5 once, in float64, and
             K4 in the grid peel's thin fronts; the value against the
             plain float64 sweep and, on a 512-point subsample, against
             the host tier to 1e-12; the distance to the front must fall
             and the hypervolume rise;
16. K5      — ``hv3d_sweep`` against the plain sweep on 8192 uniform
             points (ref (1, 1, 1)) and on path A's final 1e5 x 3
             population, float32 and float64: total and slab partials,
             two launches bitwise equal, time (CUDA events, and the
             device time alone from ``torch.profiler``) against its
             bound;
17. main path B — the default ``BENCH_PROBLEM=zdt1`` at POP 1e5 (2
             objectives, 30 variables, staircase ranks): a few
             generations, fronts per generation, the 2-D hypervolume at
             ref (11, 11) must rise (no kernel of the port runs on it);
18. P1-P4   — the probe kernels of ``kernels/probes.cu`` against their
             plain versions at the GA probe tool's shape, 2^20 x 128
             float32: the copy (rows 512 / 2048 / 8192 a block), the
             24-step FMA chain, the rastrigin row reduce (dim 100), the
             counter-hash normals, the table lookup and the row gather;
             times beside the bound and the library call (``copy_``,
             ``order[pos]``, ``index_select``); the reduce (three), the
             lookup and ``order[pos]`` (five each) as the median of
             readings host-paced and with the launches queued (device
             time); the reduce also at 1, 2047, 2048, 2049 and 2^16 + 96
             rows by dims 0, 1, 31, 32, 33, 37, 96, 100, 127 and 128 on
             rows that put warps on the branch-free cosine, the general
             one and both (NaN and +-inf lanes too); the branch-free
             cosine against ``xla_sincos`` on every 7th float32 of |y| <
             120; the normals also at 1, 2047 and 2049 rows under this
             run's seed and a second one; the lookup also at 1, 3, 4, 5,
             1023, 2^20 and 2^20 + 3 queries into a table of another
             size, ``pos`` 0-3 words into its allocation;
19. probe tool — ``python -m deap_tpu_torch.probes.ga`` in process at
             2^20 x 100, every probe, ``--recommend``, ``--json
             chip_smoke_out/probe_ga.json``: P1-P4 launched on it, every
             record a finite time above zero, ``varveval`` under both key
             implementations (``torch_varveval_rbg`` too) and no error;
             the linearity witnesses and the recommended gather;
20. P5      — ``probe_gp`` against its plain version on the GP tool's
             4096 full binary trees (capacity 64) at 1024 points: every
             mode, tb 8 and 32, unroll 1 and 63; then in every form on
             ``probes.gp.probe_edges``: 4097 trees (a group with
             missing trees), 1000 points and 1 point, cap 256 with trees
             shorter than 63 tokens and up to 256, codes outside the
             branches;
21. probe tool — ``python -m deap_tpu_torch.probes.gp`` in process: the
             nine probes and ``fraction_of_floor``, P5 and K6 (``real63``)
             launched on it;
22. OneMax — BASELINE config 1 (``bench_onemax.py``: pop 300 x 100
             bits, ``cx_two_point``, ``mut_flip_bit(0.05)``,
             ``sel_tournament(3)``, cxpb 0.5, mutpb 0.2) through
             ``ea_simple`` with ``HallOfFame(1)`` and max / avg
             statistics, 40 generations on the card and on the CPU from
             ``PRNGKey(0)``: population, logbook and archive bit for bit
             equal; the generation where the maximum reaches 100; the
             marginal ms a generation (20 / 40, three pairs);
23. CMA-ES  — BASELINE config 3 (``bench_cma.py``: N = 100, lambda =
             4096, centroid 5, sigma 5) on ``sphere`` and ``ackley``
             through ``ea_generate_update``: five generations, then one
             step teacher-forced, the same state, key and population on
             the card and on the CPU (genomes and ``centroid``,
             ``sigma``, ``ps``, ``pc``, ``C``, ``diagD`` within
             ``CMA_RTOL`` of each field's largest value; ``B`` up to the
             sign of its columns within ``CMA_B_ATOL``; ``pc`` and ``C``
             only where ``hsig``'s margin exceeds ``CMA_HSIG_MARGIN``);
             TF32 must be off; ``eigh`` must run on the card (device
             kernels under the profiler), its ms and share of a
             generation; the marginal ms a generation (10 / 20, three
             pairs) and one profiled window;
24. anchors — verify flow 2 (sphere, N = 5, lambda = 20, 100
             generations, ``PRNGKey(0)``): best < 1e-8; (1+lambda)
             (N = 5, lambda = 8, 300 generations, ``PRNGKey(10)``): best
             < 1e-3;
25. MO-CMA-ES — ZDT1 as ``tests/test_algorithms.py:178`` runs it (MU =
             LAMBDA = 10, 500 generations, ``RandomState(128)``) with
             the strategy on the card: hypervolume at (11, 11) > 116
             and the device and host selection routes choosing the same
             individuals on every generation's candidates.  No kernel
             of the port runs on phases 22-25 (their launch counts are
             printed, zero);
26. rbg     — the ``rbg`` key implementation (``PRNGKey(0,
             impl="rbg")``, the default of ``bench.py``, ``bench_onemax.py``,
             ``bench_cma.py`` and ``bench_evopole.py``): ``bits`` of three
             raw keys equal to the words jax gives; ``split``,
             ``fold_in``, ``bits``, ``uniform``, ``normal`` (float32 and
             bfloat16), ``bernoulli`` and ``randint`` at 2^20 draws, from
             one key and from a (4096, 4) key batch, card equal to CPU bit
             for bit; the ms of 1e6 uniforms under rbg and threefry;
27. flagship under rbg — phase 5's ``ea_simple`` (megakernel engine,
             rastrigin, 1e6 x 100 float32) from an rbg key: N = 10 and 2N
             generations, three pairs, K2 once a generation, the best
             fitness must fall; three generations at 10240 x 100
             teacher-forced card against CPU (offspring bitwise, fitness
             within rtol 1e-5); the live-mask ``ea_step`` with K1's
             launches counted;
28. OneMax and CMA-ES under rbg — phases 22 and 23 (sphere) from
             ``PRNGKey(0, impl="rbg")``;
29. evopole — BASELINE config 5 at ``bench_evopole.py``'s defaults
             (pop 256, 4 episodes of at most 500 CartPole steps, an MLP
             policy 4 -> tanh 16 -> 2 as a dict genome, blend crossover
             and Gaussian weight mutation, ``sel_tournament(3)``, cxpb 0.5,
             mutpb 0.8, rbg keys) through ``ea_simple`` with
             ``HallOfFame(1)``: three generations on the card and on the
             CPU, genomes, fitness, logbook and archive bit for bit; the
             marginal ms a generation (2 / 4, two pairs); one
             generation with the masked rollout (same fitness); 50 rollout
             steps under the profiler (kernel launches a step, device idle
             share); the maximum fitness must rise over 5 generations
             (from this key it starts at its ceiling, 500: then it must
             stay there and the average rise); no kernel of the port
             runs (launch counts printed, zero);
30. permutation — ``random.permutation`` at 2^20 (two shuffle rounds)
             and 1000 (one) under both key implementations, card equal
             to CPU bit for bit; later, after phase 31's DTLZ2 run,
             ``sel_tournament_dcd`` on that 1e5-point population card
             against CPU, bitwise;
31. NSGA-III — ``bench_nsga2.py`` with ``BENCH_SELECT=nsga3``
             (``uniform_reference_points`` with 99 divisions at two
             objectives, 12 at three) on ZDT1 and DTLZ2: one generation
             at POP 4096 card against CPU (offspring, objective values
             and selected indices bitwise), then POP 1e5 (pool 2e5):
             N = 2 and 2N generations, three pairs (median marginal
             ms), launches counted (K4 in the grid peel's thin fronts at
             three objectives), DTLZ2's mean ``|sum f^2 - 1|`` must fall
             and ZDT1's hypervolume at (11, 11) rise;
32. SPEA2  — ``BENCH_SELECT=spea2`` (chunk 500 at POP 1e5) likewise on
             both problems (N = 1, one pair; K4 a generation, the
             strength with the roles swapped) and ``BENCH_STAGED=1`` on
             DTLZ2 (N = 1, one pair), the POP 4096 generation card
             against CPU for each; the single program against the two
             stage calls on the card; the truncation branch card against
             CPU (8192 DTLZ2 points on the true front, k = 4096);
33. examples — ``examples/ga/nsga2.py`` (ZDT1, mu 64, 100
             generations; hypervolume > 116) and ``examples/ga/nsga3.py``
             (DTLZ2, 92, 100; its front error) at their defaults, card
             and CPU populations bitwise;
34. GP operators — on a POP 4096 x CAP 64 population three bench
             generations old (the semantic operators on the bench set
             with ``lf``): ``mut_node_replacement``, ``mut_ephemeral``
             (one and all), ``mut_insert``, ``mut_shrink``,
             ``mut_semantic``, ``cx_semantic`` and ``static_limit``
             (height 17) around ``cx_one_point`` and ``mut_uniform``, the
             card's children against the CPU's from the same keys
             bitwise, then K6 on the children against the plain
             interpreter bitwise (time, bound);
35. HARM-GP — two generations at POP 512 (2000 natural children) on the
             bench toolbox, each from the CPU's population before it, card
             against CPU (trees bitwise, fitness within rtol 1e-5), then
             POP 4096 with symbreg_harm.py's parameters: N = 2 and 2N,
             three pairs (median marginal ms), K6 once a generation and
             once before, the mean size;
36. the bench generation with each new mutation in place of
             ``mut_uniform`` and with ``static_limit`` on both operators
             (N = 2 and 2N, three pairs, K6 once a generation);
37. lexicase — ``sel_lexicase``, ``sel_epsilon_lexicase``,
             ``sel_automatic_epsilon_lexicase`` and
             ``sel_double_tournament`` (both orders) card against CPU on
             512 trees' errors at 128 points, bitwise; then automatic
             epsilon-lexicase alone over the bench population's 4096 x
             1024 case errors (three calls, median) and two bench
             generations that select with it (K6 counted);
38. GP examples — the eight of ``deap_tpu_torch/examples/gp/`` at their
             defaults on the card, each against ``tests/test_examples.py``'s
             check, and card = CPU bitwise on the final population (trees
             and every individual's fitness; the ant at the tests' depth
             of 3 generations: the CPU would take minutes);
39. the ``kernels`` line, the card's name and power limit, and the result
   line.

``python3 chip_smoke.py --profile`` adds, after phases 5, 9, 12, 15, 35
and 37, a per-stage and ``torch.profiler`` breakdown of a main-path
generation of each path.

Tolerance: K1-K4, K6 and P1-P5 must equal their plain versions bit for
bit (the stated ulp bound is 0; K6's NaNs compare equal whatever their
payload; P3's lookup is exact).
K5's running heights are exact and its sums are taken in another order
than the plain version's (with fused multiply-adds): relative 1e-4 in float32 and 1e-11 in float64,
on the total and on every slab partial (relative to the total).  A
mismatch prints the measured bound and fails.
CMA-ES (phase 23): the card's and the CPU's matrix products and
``eigh`` (cuSOLVER's Jacobi solver on the card, LAPACK on the host)
round differently, so each state field must agree within relative
1e-4, and ``|B_cardᵀ B_cpu|`` with I within 1e-2.
Any failed phase exits non-zero without the result line.  No JAX, and
nothing of the JAX package, is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

POP, DIM = 1_000_000, 100
NGEN = 30
TIMING_PAIRS = 5
LIVE_GENS = 3
# the NSGA-II slice: bench_nsga2.py's DTLZ2 sub-config at BENCH_POP
MO_POP, MO_NOBJ, MO_DIM = 100_000, 3, 12
MO_NGEN = 3
MO_PAIRS = 3
MO_HEAD_GENS = 3
MO_CXPB, MO_MUTPB, MO_SIGMA, MO_INDPB = 0.6, 0.3, 0.1, 1.0 / 12
FRONT_CHUNK = 1024
ULP_BOUND = 0                      # kernels equal their plain versions
# bench_nsga2.py as published: SBX and polynomial mutation (eta 20), cxpb
# 0.9, mutpb 1.0, sel_nsga2(nd="auto", front_chunk=1024), POP 1e5
BN_POP, BN_NGEN, BN_PAIRS = 100_000, 3, 3
BN_CXPB, BN_MUTPB, BN_ETA = 0.9, 1.0, 20.0
BN_PROBLEMS = {"dtlz2": (3, 12), "zdt1": (2, 30)}     # nobj, variables
BN_REF_POP = 1024
BN_B_GENS = 3
HV_REF = {"dtlz2": (1.1, 1.1, 1.1), "zdt1": (11.0, 11.0)}
HV_UNIFORM_N = 8192                # bench_weakscaling.py's hv layout, 1 chip
HV_SUBSAMPLE = 512                 # what the host tier takes in a moment
HV_RTOL = {"float32": 1e-4, "float64": 1e-11}
CXPB, MUTPB, MU, SIGMA, INDPB = 0.9, 0.5, 0.0, 0.3, 0.05
# K3 beyond the two main-path shapes: (parents, children, genes)
K3_EDGES = ((100_000, 123_457, 1), (100_000, 65_537, 3),
            (100_000, 77_777, 12), (100_000, 54_321, 100),
            (20_000, 30_011, 1000))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, ints: float = 0, flts: float = 0,
             dbls: float = 0):
    """The least time of a kernel's work at the H100's data-sheet peaks
    (:func:`deap_tpu_torch.kernels.peaks.bound_ms`)."""
    from deap_tpu_torch.kernels.peaks import bound_ms as least
    return least(n_bytes, ints, flts, dbls)


_START = time.perf_counter()


def phase(name: str, card_line: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": name, "card": card_line, **fields,
                      "elapsed_s": time.perf_counter() - _START}),
          flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
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


def ulp_gap(a, b) -> int:
    """Largest distance in units in the last place between two float32 (or
    narrower, widened) tensors; 0 means bitwise-equal."""
    import torch
    a, b = a.float().contiguous(), b.float().contiguous()
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def tile_counts(seed, knobs, n: int, dim: int) -> dict:
    """The data-dependent work of the tile function under this run's
    draws: pairs that mate, rows whose mutation gate opens, genes that
    mutate."""
    import torch
    from deap_tpu_torch.ops.generation import M32, _uniform_at
    useed = seed.reshape(()).to(torch.int64) & M32
    rows = torch.arange(n, dtype=torch.int64, device=seed.device)
    lanes = torch.arange(dim, dtype=torch.int64, device=seed.device)
    a_rows = rows[(rows & 16) == 0]
    mating = int((_uniform_at(useed, 1, a_rows, 0) < knobs[0]).sum().item())
    gated = rows[_uniform_at(useed, 2, rows, 0) < knobs[1]]
    mutated = 0
    for lo in range(0, gated.numel(), 1 << 17):   # bounded temporaries
        u = _uniform_at(useed, 3, gated[lo:lo + (1 << 17), None],
                        lanes[None, :])
        mutated += int((u < knobs[4]).sum().item())
    return {"pairs": n // 2, "mating_pairs": mating,
            "gated_rows": int(gated.numel()), "mutated_genes": mutated}


# Instructions the tile function needs (an FMA is one), counted from
# megakernel.cu and charged where the function needs them, not where the
# kernel's one-thread-per-gene layout repeats them:
#   one uniform (counter hash): 14 integer (counter 3, seed xor 1, mix32 8,
#     shift 1, conversion 1) and 1 float (the 2^-24 scale);
#   per pair: draw 1 at three lanes and the cxpb compare; per mating pair
#     the cut points, 10 integer and 4 float;
#   per row: the gate (draw 2) and its compare;
#   per gene of a mating row: swap test and select, 3 integer;
#   per gene of a gated row: draw 3 and the indpb compare;
#   per mutated gene: XLA's erf_inv over log1p and the update, 5 integer
#     and 70 float, plus widening and narrowing in a narrow storage.
# A gene that is only copied or only swapped moves its stored bits as
# they are.
_HASH = (14, 1)
_MUTATE = (5, 70)
_WIDEN_NARROW = {"float32": (0, 0), "bfloat16": (2, 0), "int8": (2, 4)}


def tile_ops(c: dict, n: int, dim: int, dtype: str):
    """``(integer, float)`` instructions of the tile over ``n`` rows."""
    hi, hf = _HASH
    ints = (3 * c["pairs"] * hi + 10 * c["mating_pairs"] + n * hi
            + 3 * 2 * c["mating_pairs"] * dim + c["gated_rows"] * dim * hi
            + c["mutated_genes"] * (_MUTATE[0] + _WIDEN_NARROW[dtype][0]))
    flts = (c["pairs"] * (3 * hf + 1) + 4 * c["mating_pairs"]
            + n * (hf + 1) + c["gated_rows"] * dim * (hf + 1)
            + c["mutated_genes"] * (_MUTATE[1] + _WIDEN_NARROW[dtype][1]))
    return ints, flts


def vary_check(kernels, G, parents, seed, knobs, dim: int, st):
    """K1 on stored ``parents`` against its plain version (widen, tile,
    narrow) on the same inputs: ``(ulp_gap, max_abs_err, ms, plain_ms,
    device_ms)``, ``device_ms`` with the launches queued
    (:func:`deap_tpu_torch.kernels.kernel_times.queued_ms`)."""
    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms

    def plain_vary():
        return G._narrow(G._vary_tile_plain(
            G._widen(parents, st.dtype, st.scale), seed, knobs, dim),
            st.dtype, st.scale)

    k1 = kernels.launch_vary(parents, seed, knobs, dim=dim, dtype=st.dtype,
                             scale=st.scale)
    p1 = plain_vary()
    torch.cuda.synchronize()
    gap = ulp_gap(k1, p1)
    err = float((k1.float() - p1.float()).abs().max().item())

    def launch():
        kernels.launch_vary(parents, seed, knobs, dim=dim, dtype=st.dtype,
                            scale=st.scale)
    ms = cuda_ms(launch)
    plain = cuda_ms(plain_vary, reps=3, warm=1)
    return gap, err, ms, plain, queued_ms(launch)


def _wall_ms(fn, reps: int = 5) -> float:
    """Host-clock ms per call of ``fn`` over synchronized repeats: the
    larger of its launch cost and its device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _profile_window(run, gens: int) -> dict:
    """``torch.profiler`` over ``run()`` (``gens`` generations): wall ms,
    device busy ms, idle share and kernel launches per generation, and
    the kernels that took most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels_ = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels_)
    top = sorted(kernels_, key=dev_us, reverse=True)[:12]
    return dict(
        gens=gens, wall_ms=wall / gens * 1e3,
        device_busy_ms=busy_us / gens / 1e3 if busy_us else "not measured",
        device_idle_share=(1.0 - busy_us / 1e6 / wall if busy_us
                           else "not measured"),
        kernel_launches=sum(e.count for e in kernels_) / gens,
        top_kernels=[{"kernel": e.key[:60], "ms": dev_us(e) / gens / 1e3,
                      "calls": e.count / gens} for e in top])


def profile_main_path(ea_step, key, pop, tb, card_line, gens=5) -> None:
    """``--profile``: where a main-path generation's time goes — the wall
    cost of each stage called alone, then ``torch.profiler`` over
    ``gens`` generations: device busy time and kernel launches against
    the wall clock, and device time by operator."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import evaluate_population
    from deap_tpu_torch.base import lex_sort_indices
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.ops.selection import tournament_positions

    n, dim = pop.genome.shape
    k_sel, k_var = random.split(key)
    w = pop.fitness.masked_wvalues()
    order = lex_sort_indices(w).to(torch.int32)
    pos = tournament_positions(k_sel, n, n, 3)
    seed = G._seed_from_key(k_var)
    knobs = G._knobs((CXPB, MUTPB, MU, SIGMA, INDPB), pop.genome.device)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "fitness sort": lambda: lex_sort_indices(w),
        "tournament_positions": lambda: tournament_positions(k_sel, n, n, 3),
        "seed word": lambda: G._seed_from_key(k_var),
        "K2 gather+vary": lambda: G.megakernel_gather_vary(
            order, pos, pop.genome, seed, knobs, dim=dim,
            storage=G.GenomeStorage()),
        "evaluate (vmap rastrigin)": lambda: evaluate_population(tb, pop),
        "whole ea_step": lambda: ea_step(key, pop, tb, CXPB, MUTPB),
    }
    phase("profile: stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f) for k, f in stages.items()})

    for _ in range(2):
        key, pop, _ = ea_step(key, pop, tb, CXPB, MUTPB)

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p, _ = ea_step(k, p, tb, CXPB, MUTPB)

    phase("profile: ea_step megakernel, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# the NSGA-II slice: K3, K4 and the (mu + lambda) loop
# ---------------------------------------------------------------------------


def var_or_counts(ia, i2, code, seed, knobs, dim: int) -> dict:
    """The data-dependent work of K3 under this run's draws: crossover and
    mutation rows, partner genes taken, genes mutated."""
    import torch
    from deap_tpu_torch.ops.generation import (M32, _cut_points,
                                               _uniform_at)
    useed = seed.reshape(()).to(torch.int64) & M32
    rows = torch.arange(code.numel(), dtype=torch.int64, device=code.device)
    cx = rows[code == 0]
    u0 = _uniform_at(useed, 4, cx, 0)
    u1 = _uniform_at(useed, 4, cx, 1)
    lo, hi = _cut_points(u0, u1, dim)
    mut = rows[code == 1]
    lanes = torch.arange(dim, dtype=torch.int64, device=code.device)
    mutated = 0
    for s in range(0, mut.numel(), 1 << 17):     # bounded temporaries
        u = _uniform_at(useed, 5, mut[s:s + (1 << 17), None], lanes[None, :])
        mutated += int((u < knobs[2]).sum().item())
    return {"rows": int(code.numel()), "cx_rows": int(cx.numel()),
            "mut_rows": int(mut.numel()),
            "partner_genes": int((hi - lo).sum().item()),
            "mutated_genes": mutated}


def var_or_bound(c: dict, dim: int, elt: int, dtype: str):
    """K3's least time: parent rows read and children written once, the
    partner genes it takes, the three index/code words per row; the cut
    pair (two draws and the cut law) per crossover row, the swap test per
    gene of a crossover row, the gene draw per gene of a mutation row,
    ``erf_inv`` and the conversions per mutated gene."""
    hi, hf = _HASH
    n = c["rows"]
    n_bytes = 2 * n * dim * elt + c["partner_genes"] * elt + 12 * n + 16
    ints = (n + c["cx_rows"] * (2 * hi + 10) + 3 * c["cx_rows"] * dim
            + c["mut_rows"] * dim * hi
            + c["mutated_genes"] * (_MUTATE[0] + _WIDEN_NARROW[dtype][0]))
    flts = (c["cx_rows"] * (2 * hf + 4) + c["mut_rows"] * dim * (hf + 1)
            + c["mutated_genes"] * (_MUTATE[1] + _WIDEN_NARROW[dtype][1]))
    return bound_ms(n_bytes, ints, flts)


def counts_bound(C: int, n: int, m: int):
    """K4's least time: every (row, column) pair is 2m float compares
    (``>=`` and ``>`` per objective, each chain folded through the
    compare's predicate input) and at least one instruction to count it,
    all at the compare/integer rate; the rows, the points and the counts
    move once.  ``python -m deap_tpu_torch.kernels.sass`` counts what
    the compiled loop spends per pair (it also joins the two chains,
    counts in two instructions, and loads and loops)."""
    return bound_ms(4 * (C * m + n * m + n), C * n * (2 * m + 1))


def dtlz2_values(genome):
    import torch
    from deap_tpu_torch import benchmarks
    return torch.stack(benchmarks.dtlz2(genome, MO_NOBJ), 1)


def front_distance(values) -> float:
    """DTLZ2's distance to its front: the mean of ``|f|_2 - 1``."""
    return float((values.double().norm(dim=1) - 1.0).mean().item())


def nsga2_toolbox():
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, emo, mutation
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.dtlz2, obj=MO_NOBJ)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=MO_SIGMA,
                indpb=MO_INDPB)
    tb.register("select", emo.sel_nsga2, nd="peel", front_chunk=FRONT_CHUNK)
    tb.generation_engine = "megakernel"
    return tb


def k3_phase(kernels, G, genome, key, card_line, n: int, dim: int,
             knobs_vals, storages, lam: int | None = None) -> dict:
    """K3 against its plain version: ``lam`` (default ``n``) children of
    ``n`` parents of ``dim`` genes; returns per dtype ``(max_abs_err, ms,
    plain_ms, bound_ms, bound_by, device_ms)``, ``device_ms`` with the
    launches queued (:func:`deap_tpu_torch.kernels.kernel_times.queued_ms`)."""
    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    lam = n if lam is None else lam
    ia, i2, code, seed = G._var_or_draws(key, n, lam, MO_CXPB, MO_MUTPB)
    knobs = torch.tensor(knobs_vals, dtype=torch.float32,
                         device=genome.device)
    counts = var_or_counts(ia, i2, code, seed, knobs, dim)
    out = {}
    for st in storages:
        gs = st.to_storage(genome)
        before = kernels.LAUNCHES["megakernel_var_or"]
        k3 = kernels.launch_var_or(gs, ia, i2, code, seed, knobs, dim=dim,
                                   dtype=st.dtype, scale=st.scale)
        p3 = G._var_or_plain(gs, ia, i2, code, seed, knobs, dim, st)
        torch.cuda.synchronize()
        gap = ulp_gap(k3, p3)
        err = float((k3.float() - p3.float()).abs().max().item())
        launches = kernels.LAUNCHES["megakernel_var_or"] - before

        def launch():
            kernels.launch_var_or(gs, ia, i2, code, seed, knobs, dim=dim,
                                  dtype=st.dtype, scale=st.scale)
        ms = cuda_ms(launch)
        dev_ms = queued_ms(launch)
        plain = cuda_ms(lambda: G._var_or_plain(gs, ia, i2, code, seed,
                                                knobs, dim, st),
                        reps=3, warm=1)
        b, by = var_or_bound(counts, dim, gs.element_size(), st.dtype)
        phase("K3 megakernel_var_or vs plain", card_line, storage=st.dtype,
              shape=[n, dim], lam=lam, ulp_gap=gap, ulp_bound=ULP_BOUND,
              max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
              bound_ms=b, bound_by=by, work=counts, launches=launches)
        if gap > ULP_BOUND:
            fail(f"K3 {st.dtype} at {lam} x {dim} from {n} parents: {gap} "
                 f"ulp from its plain version (bound {ULP_BOUND})")
        out[st.dtype] = (err, ms, plain, b, by, dev_ms)
        del gs, k3, p3
        torch.cuda.empty_cache()
    return out


def k4_phase(kernels, D, key, card_line) -> dict:
    """K4 against its plain counts on the DTLZ2 values of a real pool:
    a front chunk of C = 1024 rows and the initial counts' C = n, with
    -inf sentinel rows and duplicated points; then SPEA2's strength form
    at C = n on ZDT1 and DTLZ2 values, with +inf rows and duplicates."""
    import torch
    from deap_tpu_torch import benchmarks, random
    n = 2 * MO_POP
    genome = random.uniform(key, (n, MO_DIM))
    w = -dtlz2_values(genome)
    w[:256] = w[256:512]                               # duplicated points
    active = torch.ones(n, dtype=torch.bool, device=w.device)
    active[::9] = False                                # -inf rows below
    out = {}
    for C in (FRONT_CHUNK, n):
        if C == n:
            rows = torch.where(active[:, None], w, float("-inf"))
        else:
            rows = w[torch.arange(0, n, n // C, device=w.device)[:C]].clone()
            rows[-24:] = float("-inf")                 # a padded chunk
        rows = rows.contiguous()
        before = kernels.LAUNCHES["rows_dominate_counts"]
        k4 = kernels.launch_rows_dominate_counts(rows, w)
        p4 = D._rows_dominate_counts_plain(rows, w)
        torch.cuda.synchronize()
        equal = torch.equal(k4, p4)
        err = float((k4 - p4).abs().max().item())
        ms = cuda_ms(lambda: kernels.launch_rows_dominate_counts(rows, w),
                     reps=10 if C < n else 3, warm=1)
        plain = cuda_ms(lambda: D._rows_dominate_counts_plain(rows, w),
                        reps=3 if C < n else 1, warm=1 if C < n else 0)
        b, by = counts_bound(C, n, MO_NOBJ)
        phase("K4 rows_dominate_counts vs plain", card_line, rows=C,
              points=n, nobj=MO_NOBJ, counts_equal=equal, max_abs_err=err,
              ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
              count_sum=int(k4.sum().item()),
              launches=kernels.LAUNCHES["rows_dominate_counts"] - before)
        if not equal:
            fail(f"K4 at C={C}: counts differ from the plain version")
        out[C] = (err, ms, plain, b, by)
    # SPEA2's strength: the roles swapped, rows_dominate_counts(-w, -w) at
    # C = n, its masked -inf rows now +inf, for ZDT1 (m = 2) and DTLZ2
    k_z = random.fold_in(key, 2)
    w_zdt1 = -torch.stack(benchmarks.zdt1(random.uniform(k_z, (n, 30))), 1)
    for m, vals in ((2, w_zdt1), (MO_NOBJ, w)):
        v = vals.clone()
        v[:256] = v[256:512]                           # duplicated points
        v[::9] = float("-inf")                         # masked rows
        nw = (-v).contiguous()                         # they read +inf
        before = kernels.LAUNCHES["rows_dominate_counts"]
        k4 = kernels.launch_rows_dominate_counts(nw, nw)
        p4 = D._rows_dominate_counts_plain(nw, nw)
        torch.cuda.synchronize()
        equal = torch.equal(k4, p4)
        err = float((k4 - p4).abs().max().item())
        ms = cuda_ms(lambda: kernels.launch_rows_dominate_counts(nw, nw),
                     reps=3, warm=1)
        plain = cuda_ms(lambda: D._rows_dominate_counts_plain(nw, nw),
                        reps=1, warm=0)
        b, by = counts_bound(n, n, m)
        phase("K4 SPEA2 strength rows_dominate_counts(-w, -w) vs plain",
              card_line, rows=n, points=n, nobj=m, inf_rows=len(v[::9]),
              counts_equal=equal, max_abs_err=err, ms=ms, plain_ms=plain,
              bound_ms=b, bound_by=by, count_sum=int(k4.sum().item()),
              launches=kernels.LAUNCHES["rows_dominate_counts"] - before)
        if not equal:
            fail(f"K4 strength at m={m}: counts differ from the plain "
                 "version")
        out[("strength", m)] = (err, ms, plain, b, by)
    return out


def nsga2_reference_phase(card_line, key) -> None:
    """One NSGA-II generation at mu = lambda = 1024, card against CPU:
    the offspring bitwise, then the card's selection on the CPU pool's
    values against the CPU's indices, then the ``ea_step`` head's
    offspring (``sel_nsga2`` and K1) bitwise."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_ask, evaluate_population, var_or
    n = 1024
    tb = nsga2_toolbox()
    k_g, k_var, k_sel = random.split(key.cpu(), 3)
    genome = random.uniform(k_g, (n, MO_DIM))
    pop = evaluate_population(tb, base.Population(
        genome, base.Fitness.empty(n, (-1.0,) * MO_NOBJ, device="cpu")))[0]
    dev = torch.device("cuda")
    pop_dev = base.Population(genome.to(dev), base.Fitness(
        pop.fitness.values.to(dev), pop.fitness.valid.to(dev),
        pop.fitness.weights))
    off_cpu = var_or(k_var, pop, tb, n, MO_CXPB, MO_MUTPB)
    off_dev = var_or(k_var.to(dev), pop_dev, tb, n, MO_CXPB, MO_MUTPB)
    same_off = torch.equal(off_cpu.genome.view(torch.int32),
                           off_dev.genome.cpu().view(torch.int32))
    pool = pop.concat(evaluate_population(tb, off_cpu)[0])
    idx_cpu = tb.select(k_sel, pool.fitness, n)
    idx_dev = tb.select(k_sel.to(dev), base.Fitness(
        pool.fitness.values.to(dev), pool.fitness.valid.to(dev),
        pool.fitness.weights), n)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    # the ea_step head (sel_nsga2, then K1) on the same parents
    head_cpu = ea_ask(k_var, pop, tb, MO_CXPB, MO_MUTPB)[1].genome
    head_dev = ea_ask(k_var.to(dev), pop_dev, tb, MO_CXPB, MO_MUTPB)[1].genome
    same_head = torch.equal(head_cpu.view(torch.int32),
                            head_dev.cpu().view(torch.int32))
    phase("reference: NSGA-II generation card vs CPU", card_line, mu=n,
          lam=n, dim=MO_DIM, offspring_bitwise=same_off,
          selection_equal=same_idx, head_offspring_bitwise=same_head)
    if not (same_off and same_idx and same_head):
        fail("NSGA-II generation on the card differs from the CPU path: "
             f"offspring equal {same_off}, selection equal {same_idx}, "
             f"ea_step head offspring equal {same_head}")


def fronts_per_generation(key, pop0, ngen: int):
    """Replay the first ``ngen`` generations of an ``ea_mu_plus_lambda``
    run, untimed, with a ``select`` that also ranks each pool by
    ``nondominated_ranks`` and keeps its number of fronts.  Returns the
    fronts per generation and the final population."""
    from deap_tpu_torch.algorithms import ea_mu_plus_lambda
    from deap_tpu_torch.ops import emo
    tb = nsga2_toolbox()
    fronts = []

    def select(k_sel, fitness, k):
        fronts.append(emo.nondominated_ranks(
            fitness.masked_wvalues(), method="peel",
            front_chunk=FRONT_CHUNK, stop_at_k=k)[1])
        return emo.sel_nsga2(k_sel, fitness, k, nd="peel",
                             front_chunk=FRONT_CHUNK)

    tb.register("select", select)
    pop, _ = ea_mu_plus_lambda(key, pop0, tb, MO_POP, MO_POP, MO_CXPB,
                               MO_MUTPB, ngen)
    return fronts, pop


def nsga2_main_path(kernels, card_line, key):
    """The NSGA-II ``ea_mu_plus_lambda`` at full width; returns the launch
    counts of its first timed run."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_mu_plus_lambda
    from deap_tpu_torch.utils.support import Statistics
    tb = nsga2_toolbox()
    stats = Statistics(lambda p: p.fitness.values)
    stats.register("dist", lambda v: (v.double().norm(dim=1) - 1.0).mean())
    k_init, k_run = random.split(key)
    genome = random.uniform(k_init, (MO_POP, MO_DIM))

    def fresh():
        return base.Population(genome.clone(), base.Fitness.empty(
            MO_POP, (-1.0,) * MO_NOBJ, device=genome.device))

    def run(ngen):
        pop0 = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_mu_plus_lambda(k_run, pop0, tb, MO_POP, MO_POP,
                                     MO_CXPB, MO_MUTPB, ngen, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    t1, pop1, _ = run(MO_NGEN)
    launches = dict(kernels.LAUNCHES)
    fronts, replay = fronts_per_generation(k_run, fresh(), MO_NGEN)
    if not torch.equal(replay.genome, pop1.genome):
        fail("the untimed replay that counts fronts left another "
             "population than the timed run")
    del pop1, replay
    t2, pop2, log2 = run(2 * MO_NGEN)
    pairs = [(t1, t2)]
    for i in range(MO_PAIRS - 1):
        if i % 2:
            a, b = run(MO_NGEN)[0], run(2 * MO_NGEN)[0]
        else:
            b, a = run(2 * MO_NGEN)[0], run(MO_NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / MO_NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    dist = log2.select("dist")
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (MO_POP, MO_DIM)
                and tuple(final.shape) == (MO_POP, MO_NOBJ)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all())
                and bool(pop2.fitness.valid.all()))
    phase("main path: NSGA-II ea_mu_plus_lambda dtlz2", card_line,
          mu=MO_POP, lam=MO_POP, dim=MO_DIM, nobj=MO_NOBJ,
          ngen=[MO_NGEN, 2 * MO_NGEN], seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs],
          launches=launches,
          launches_per_gen={k: v / MO_NGEN for k, v in launches.items()},
          fronts_per_gen=fronts, distance_start=dist[0],
          distance_end=dist[-1], finite_and_shaped=ok_shape)
    if launches["megakernel_var_or"] != MO_NGEN:
        fail(f"K3 ran {launches['megakernel_var_or']} times in {MO_NGEN} "
             "NSGA-II generations (once per generation expected)")
    if launches["rows_dominate_counts"] < MO_NGEN:
        fail(f"K4 ran {launches['rows_dominate_counts']} times in "
             f"{MO_NGEN} NSGA-II generations (at least once each expected)")
    if not dist[-1] < dist[0]:
        fail(f"DTLZ2 distance did not fall: {dist[0]} -> {dist[-1]}")
    if not ok_shape:
        fail("final NSGA-II population is not finite, valid and shaped")
    return launches, pop2, tb


def nsga2_head_phase(kernels, G, card_line, key, pop, tb) -> tuple:
    """The NSGA-II head of ``ea_step`` (``sel_nsga2`` of ``pop`` parents,
    then K1).  First K1 on one generation's parents and knobs against
    its plain version in the three storage dtypes; then a few generations
    at full width with the launches counted.  Returns the launches and
    the per-dtype ``(max_abs_err, ms, plain_ms, device_ms, bound_ms,
    bound_by)`` of K1 at this shape."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import ea_step
    k_sel, k_var = random.split(key, 3)[1:]
    idx = tb.select(k_sel, pop.fitness, MO_POP)
    params = G.megakernel_variation_params(tb)
    seed = G._seed_from_key(k_var)
    knobs = G._knobs((MO_CXPB, MO_MUTPB, params["mut_mu"],
                      params["mut_sigma"], params["indpb"]), pop.genome.device)
    counts = tile_counts(seed, knobs, MO_POP, MO_DIM)
    checks = {}
    for st in (G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
               G.GenomeStorage("int8", 1.0)):       # DTLZ2 genes: [0, 1]
        parents = st.to_storage(pop.genome[idx.long()]).contiguous()
        gap, err, ms, plain, dev_ms = vary_check(kernels, G, parents, seed,
                                                 knobs, MO_DIM, st)
        b, by = bound_ms(2 * MO_POP * MO_DIM * parents.element_size() + 24,
                         *tile_ops(counts, MO_POP, MO_DIM, st.dtype))
        phase("K1 megakernel_vary vs plain, NSGA-II head inputs", card_line,
              storage=st.dtype, shape=[MO_POP, MO_DIM], ulp_gap=gap,
              ulp_bound=ULP_BOUND, max_abs_err=err, ms=ms,
              device_ms=dev_ms, plain_ms=plain, bound_ms=b, bound_by=by,
              work=counts)
        if gap > ULP_BOUND:
            fail(f"K1 {st.dtype} on the NSGA-II head's parents: {gap} ulp "
                 f"from its plain version (bound {ULP_BOUND})")
        checks[st.dtype] = (err, ms, plain, dev_ms, b, by)

    d0 = front_distance(pop.fitness.values)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(MO_HEAD_GENS):
        key, pop, _ = ea_step(key, pop, tb, MO_CXPB, MO_MUTPB)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    ok = bool(torch.isfinite(pop.fitness.values).all()
              and pop.fitness.valid.all())
    phase("NSGA-II ea_step head (sel_nsga2 + K1)", card_line, pop=MO_POP,
          dim=MO_DIM, gens=MO_HEAD_GENS,
          ms_per_gen=secs / MO_HEAD_GENS * 1e3, launches=launches,
          distance_start=d0, distance_end=front_distance(pop.fitness.values),
          finite_and_valid=ok)
    if launches["megakernel_vary"] != MO_HEAD_GENS:
        fail(f"K1 ran {launches['megakernel_vary']} times in "
             f"{MO_HEAD_GENS} NSGA-II head generations")
    if launches["rows_dominate_counts"] < MO_HEAD_GENS or not ok:
        fail("the NSGA-II head did not count dominance through K4 or left "
             "an invalid population")
    return launches, checks


def profile_nsga2(key, pop, tb, card_line, gens=2) -> None:
    """``--profile`` for the NSGA-II path: the wall cost of each stage of
    a generation called alone, then ``torch.profiler`` over ``gens``
    generations of the loop."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import (ea_mu_plus_lambda,
                                           evaluate_population, var_or)
    from deap_tpu_torch.base import lexsort
    from deap_tpu_torch.ops import emo

    k_var, k_sel = random.split(key)
    off = evaluate_population(tb, var_or(k_var, pop, tb, MO_POP, MO_CXPB,
                                         MO_MUTPB))[0]
    pool = pop.concat(off)
    w, values = emo._wv_values(pool.fitness)
    n = w.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=w.device)
    counts = emo._dominator_counts(w, ones)
    ranks, _ = emo._peel_from_counts(w, counts, MO_POP, FRONT_CHUNK)
    dist = emo.assign_crowding_dist(values, ranks)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "var_or (draws + K3)": lambda: var_or(k_var, pop, tb, MO_POP,
                                              MO_CXPB, MO_MUTPB),
        "evaluate (dtlz2, batched form)": lambda: evaluate_population(tb, off),
        "concat": lambda: pop.concat(off),
        "initial counts (K4, C = n)": lambda: emo._dominator_counts(w, ones),
        "peel (host-read rounds, K4 chunks)": lambda: emo._peel_from_counts(
            w, counts, MO_POP, FRONT_CHUNK),
        "crowding distance": lambda: emo.assign_crowding_dist(values, ranks),
        "final sort": lambda: lexsort([-dist, ranks]),
        "whole sel_nsga2": lambda: tb.select(k_sel, pool.fitness, MO_POP),
    }
    phase("profile: NSGA-II stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})
    phase("profile: NSGA-II ea_mu_plus_lambda, per generation", card_line,
          **_profile_window(lambda: ea_mu_plus_lambda(
              key, pop, tb, MO_POP, MO_POP, MO_CXPB, MO_MUTPB, gens), gens))


# ---------------------------------------------------------------------------
# the GP slice: K6 and bench_gp.py's symbolic regression
# ---------------------------------------------------------------------------

# bench_gp.py's configuration at full width
GP_POP, GP_CAP, GP_NPOINTS = 4096, 64, 1024
GP_CXPB, GP_MUTPB = 0.5, 0.1
GP_NGEN, GP_PAIRS = 10, 3
GP_EA_GENS = 3
GP_REF_POP = 256
GP_FITNESS_RTOL = 1e-5     # the user's MSE mean reduces in another order
# Instructions each executed token needs per point, as (integer and
# compare, float32, float64), counted from gp_interp.cu's algorithm and
# charged at the cheapest path: a push moves a value and needs none;
# the protected division a compare and a correctly rounded division
# (reciprocal, two Newton steps, residual and correction: 8); sin and
# cos the |y| < 0.75 path (3 integer for the path test, the double
# polynomial 9 / 11 and the two conversions); log, sqrt and logistic
# XLA's float32 forms; the boolean ops compares and a select.
GP_OP_COST = {
    "arg": (0, 0, 0), "const": (0, 0, 0), "add": (0, 1, 0),
    "sub": (0, 1, 0), "mul": (0, 1, 0), "div": (1, 8, 0), "neg": (0, 1, 0),
    "sin": (3, 0, 11), "cos": (3, 0, 13), "log": (6, 18, 0),
    "sqrt": (1, 5, 0), "lf": (4, 23, 0), "and": (4, 0, 0), "or": (4, 0, 0),
    "xor": (4, 0, 0), "not": (2, 0, 0), "if": (2, 0, 0)}


def gp_toolbox(dev, pset_kind: str = "bench", per_tree: bool = False,
               **options):
    """bench_gp.py's primitive set, data and toolbox on ``dev``
    (``deap_tpu_torch.probes.gp.bench_toolbox``, with its operator and
    selection ``options``); ``"all"`` is a second set with every opcode
    of K6's table, ``"semantic"`` the bench set with ``lf``."""
    from deap_tpu_torch.probes.gp import bench_toolbox
    return bench_toolbox(dev, pset_kind, per_tree, GP_CAP, GP_NPOINTS,
                         **options)


def gp_initial(tb, gen_init, key, n: int, nobj: int = 1):
    """``n`` half-and-half trees of depth 1-3, evaluated (``nobj``
    objectives)."""
    from deap_tpu_torch.probes.gp import bench_initial
    return bench_initial(tb, gen_init, key, n, nobj)


def gp_generation(tb, key, pop):
    """bench_gp.py's generation (``probes.gp.bench_generation``).
    Returns ``(key, offspring, idx)``."""
    from deap_tpu_torch.probes.gp import bench_generation
    return bench_generation(tb, key, pop, GP_CXPB, GP_MUTPB)


def gp_token_work(frozen, codes, lengths, n_points: int):
    """The tokens K6 executes on this input: per opcode, the tokens of
    the rows it runs (``length > 0``) times ``n_points``; and the bytes
    it must move (those tokens' codes and constants, the lengths, ``X``
    and the output)."""
    import torch
    from deap_tpu_torch.gp.interp_cuda import OPCODES
    t = frozen.tables(codes.device)
    p = torch.arange(codes.shape[1], device=codes.device)
    live = p[None, :] < lengths[:, None]
    ops = t["op_kind"][codes.long()][live].long()
    hist = torch.bincount(ops, minlength=len(OPCODES)).tolist()
    names = {v: k for k, v in OPCODES.items()}
    tokens = {names[i]: int(c) for i, c in enumerate(hist) if c}
    n_tok = sum(tokens.values())
    pop = codes.shape[0]
    n_bytes = (8 * n_tok + 4 * pop
               + 4 * n_points * len(frozen.pset.arguments)
               + 4 * pop * n_points)
    return tokens, n_bytes


def gp_bound(tokens: dict, n_bytes: int, n_points: int):
    """K6's least time: the larger of its bytes over the memory rate and
    its tokens' instructions over the integer, float32 and float64
    rates and the issue slots."""
    ints = sum(GP_OP_COST[k][0] * v for k, v in tokens.items()) * n_points
    flts = sum(GP_OP_COST[k][1] * v for k, v in tokens.items()) * n_points
    dbls = sum(GP_OP_COST[k][2] * v for k, v in tokens.items()) * n_points
    return bound_ms(n_bytes, ints, flts, dbls)


def nan_gap(a, b):
    """``(bitwise equal with NaN == NaN, max |a - b| elsewhere)``."""
    import torch
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    diff = torch.where(same, 0.0, (a - b).abs().nan_to_num(float("inf")))
    return bool(same.all()), float(diff.max().item()) if diff.numel() else 0.0


def k6_check(kernels, card_line, label: str, frozen, genome, X) -> dict:
    """K6 against the plain interpreter on one input: bitwise, times and
    bound; fails on a mismatch."""
    import torch
    from deap_tpu_torch import gp
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    codes, consts, lengths = (g.contiguous() for g in genome)
    t = frozen.tables(X.device)

    def kernel():
        return kernels.launch_gp_interp(codes, consts, lengths, X,
                                        t["op_kind"], t["arg_index"])

    def plain():
        return gp.run_stack_machine(codes, consts, lengths, X, frozen,
                                    codes.shape[1])

    k6, p6 = kernel(), plain()
    torch.cuda.synchronize()
    equal, err = nan_gap(k6, p6)
    ms = cuda_ms(kernel, reps=20, warm=2)
    dev_ms = queued_ms(kernel)
    plain_ms = cuda_ms(plain, reps=1, warm=0)
    tokens, n_bytes = gp_token_work(frozen, codes, lengths, X.shape[1])
    b, by = gp_bound(tokens, n_bytes, X.shape[1])
    run = lengths > 0
    phase(f"K6 gp_interp vs plain: {label}", card_line,
          shape=[*codes.shape, X.shape[1]], n_args=X.shape[0],
          bitwise_equal=equal, ulp_bound=ULP_BOUND, max_abs_err=err, ms=ms,
          device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
          rows_run=int(run.sum().item()),
          mean_length_run=float(lengths[run].float().mean().item())
          if bool(run.any()) else 0.0,
          tokens=tokens, nan_share=float(k6.isnan().float().mean().item()))
    if not equal:
        fail(f"K6 on {label}: differs from the plain interpreter "
             f"(max abs err {err})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}


def gp_reference_phase(card_line, key, dev) -> None:
    """One bench generation at pop 256, card against CPU: the trees after
    ``var_and`` bitwise, the selection indices equal (the card is given
    the CPU's fitness), the fitness within ``GP_FITNESS_RTOL``."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import var_and
    cpu = torch.device("cpu")
    _, tb_cpu, ev_cpu, gen_cpu, _ = gp_toolbox(cpu)
    _, tb_dev, ev_dev, _, _ = gp_toolbox(dev)
    k_init, k_gen = random.split(key.cpu())
    pop = gp_initial(tb_cpu, gen_cpu, k_init, GP_REF_POP)
    for _ in range(3):          # a few generations: longer, varied trees
        k_gen, pop, _ = gp_generation(tb_cpu, k_gen, pop)
    pop_dev = base.Population(tuple(g.to(dev) for g in pop.genome),
                              base.Fitness(pop.fitness.values.to(dev),
                                           pop.fitness.valid.to(dev),
                                           pop.fitness.weights))
    _, off_cpu, idx_cpu = gp_generation(tb_cpu, k_gen, pop)
    _, off_dev, idx_dev = gp_generation(tb_dev, k_gen.to(dev), pop_dev)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    # var_and alone on the same parents
    k_var = random.split(k_gen, 3)[2]
    v_cpu = var_and(k_var, pop.take(idx_cpu), tb_cpu, GP_CXPB, GP_MUTPB,
                    pairing="halves")
    v_dev = var_and(k_var.to(dev), pop_dev.take(idx_cpu.to(dev)), tb_dev,
                    GP_CXPB, GP_MUTPB, pairing="halves")
    same_trees = all(torch.equal(a, b.cpu())
                     for a, b in zip(v_cpu.genome, v_dev.genome))
    same_off = all(torch.equal(a, b.cpu())
                   for a, b in zip(off_cpu.genome, off_dev.genome))
    fc, fd = off_cpu.fitness.values, off_dev.fitness.values.cpu()
    rel = float(((fc - fd).abs() / fc.abs().clamp(min=1e-30)).max().item())
    ok_fit = bool(torch.allclose(fd, fc, rtol=GP_FITNESS_RTOL, atol=0.0))
    phase("reference: GP bench generation card vs CPU", card_line,
          pop=GP_REF_POP, cap=GP_CAP, points=GP_NPOINTS,
          selection_equal=same_idx, var_and_trees_bitwise=same_trees,
          offspring_trees_bitwise=same_off, fitness_max_rel_err=rel,
          fitness_rtol=GP_FITNESS_RTOL, backends=[ev_cpu.last_backend,
                                                  ev_dev.last_backend])
    if not (same_idx and same_trees and same_off and ok_fit):
        fail("the GP generation on the card differs from the CPU path: "
             f"selection {same_idx}, trees {same_trees}/{same_off}, "
             f"fitness rel err {rel}")
    if ev_dev.last_backend != ev_dev.resolve(pop_dev.genome[1]):
        fail("the card's evaluator did not take its device's route")
    # the reference examples' per-tree registration on the card: one
    # operator call a row, the same generation as the CPU's rowwise one
    _, tb_tree, ev_tree, _, _ = gp_toolbox(dev, per_tree=True)
    _, off_tree, idx_tree = gp_generation(tb_tree, k_gen.to(dev), pop_dev)
    same_idx = torch.equal(idx_cpu, idx_tree.cpu())
    same_off = all(torch.equal(a, b.cpu())
                   for a, b in zip(off_cpu.genome, off_tree.genome))
    fd = off_tree.fitness.values.cpu()
    rel = float(((fc - fd).abs() / fc.abs().clamp(min=1e-30)).max().item())
    ok_fit = bool(torch.allclose(fd, fc, rtol=GP_FITNESS_RTOL, atol=0.0))
    phase("reference: GP generation, per-tree registration, card vs CPU",
          card_line, pop=GP_REF_POP, selection_equal=same_idx,
          offspring_trees_bitwise=same_off, fitness_max_rel_err=rel,
          fitness_rtol=GP_FITNESS_RTOL, backend=ev_tree.last_backend)
    if not (same_idx and same_off and ok_fit):
        fail("the per-tree-registered GP generation on the card differs "
             f"from the CPU's: selection {same_idx}, trees {same_off}, "
             f"fitness rel err {rel}")


def fault_reference_phase(card_line, key, dev) -> None:
    """Card against CPU, bit for bit: an ``ea_step(reevaluate_all=True)``
    generation on the xla engine (pop 1024 x 100, the flagship's
    operators, the fitness the largest gene: exact on both devices), and
    ``mut_gaussian`` on a float32 genome (4096 x 100; ``mu`` 0 and 0.5 as
    Python numbers, ``mu`` and ``sigma`` as tensors: the three forms of
    the jitted program) and on a bfloat16 one."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    from deap_tpu_torch.ops import crossover, mutation, selection
    cpu = torch.device("cpu")
    k_g, k_step, k_bf, k_f32 = random.split(key.cpu(), 4)
    genome = random.uniform(k_g, (1024, DIM), minval=-5.12, maxval=5.12)
    outs = []
    for d in (dev, cpu):
        tb = base.Toolbox()
        tb.register("evaluate", lambda g: (torch.max(g),))
        tb.register("mate", crossover.cx_two_point)
        tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                    indpb=INDPB)
        tb.register("select", selection.sel_tournament, tournsize=3)
        pop = base.Population(genome.to(d), base.Fitness.empty(
            1024, (1.0,), device=d))
        pop, _ = evaluate_population(tb, pop)
        _, off, nevals = ea_step(k_step.to(d), pop, tb, CXPB, MUTPB,
                                 reevaluate_all=True)
        outs.append((off.genome.cpu(), off.fitness.values.cpu(),
                     int(nevals)))
    same = (torch.equal(outs[0][0].view(torch.int32),
                        outs[1][0].view(torch.int32))
            and torch.equal(outs[0][1].view(torch.int32),
                            outs[1][1].view(torch.int32))
            and outs[0][2] == outs[1][2])
    phase("reference: ea_step reevaluate_all (xla engine) card vs CPU",
          card_line, pop=1024, dim=DIM, nevals=outs[1][2],
          bitwise_equal=same)
    if not same:
        fail("ea_step(reevaluate_all=True) on the card differs from the CPU")
    g32 = genome.repeat(4, 1)
    forms = {"mu 0": (0.0, SIGMA), "mu 0.5": (0.5, SIGMA),
             "tensor mu and sigma": (torch.tensor(0.5), torch.tensor(SIGMA))}
    equal = {}
    for form, (mu, sigma) in forms.items():
        m = [mutation.mut_gaussian(
                 k_f32.to(d), g32.to(d),
                 *(v.to(d) if torch.is_tensor(v) else v for v in (mu, sigma)),
                 0.2).cpu() for d in (dev, cpu)]
        equal[form] = torch.equal(m[0].view(torch.int32),
                                  m[1].view(torch.int32))
    phase("reference: float32 mut_gaussian card vs CPU", card_line,
          shape=list(g32.shape), mutated_share=float(
              (m[1] != g32).float().mean().item()), bitwise_equal=equal)
    if not all(equal.values()):
        fail(f"float32 mut_gaussian on the card differs from the CPU: "
             f"{equal}")
    g16 = genome.repeat(4, 1).to(torch.bfloat16)
    m = [mutation.mut_gaussian(k_bf.to(d), g16.to(d), 0.5, SIGMA, 0.2).cpu()
         for d in (dev, cpu)]
    same = (m[0].dtype == torch.bfloat16
            and torch.equal(m[0].view(torch.int16), m[1].view(torch.int16)))
    phase("reference: bfloat16 mut_gaussian card vs CPU", card_line,
          shape=list(g16.shape), mutated_share=float(
              (m[1] != g16).float().mean().item()), bitwise_equal=same)
    if not same:
        fail("bfloat16 mut_gaussian on the card differs from the CPU")


def gp_main_path(kernels, card_line, key, dev):
    """bench_gp.py's generation at full width, N and 2N generations in
    GP_PAIRS pairs; then ``ea_simple`` on the same toolbox.  Returns the
    launches of the first timed run, the population after 2N
    generations, the initial one and the toolbox."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.utils.support import Statistics
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev)
    k_init, k_run, k_ea = random.split(key, 3)
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop, bests = k_run, pop0, []
        for _ in range(ngen):
            k, pop, _ = gp_generation(tb, k, pop)
            bests.append(pop.fitness.values.min())
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, torch.stack(bests).tolist()

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    t1, _, _ = run(GP_NGEN)
    launches = dict(kernels.LAUNCHES)
    t2, pop2, best2 = run(2 * GP_NGEN)
    pairs = [(t1, t2)]
    for i in range(GP_PAIRS - 1):
        if i % 2:
            a, b = run(GP_NGEN)[0], run(2 * GP_NGEN)[0]
        else:
            b, a = run(2 * GP_NGEN)[0], run(GP_NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / GP_NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    best0 = float(pop0.fitness.values.min().item())
    len0 = float(pop0.genome[2].float().mean().item())
    len2 = float(pop2.genome[2].float().mean().item())
    ok = (tuple(pop2.genome[0].shape) == (GP_POP, GP_CAP)
          and bool(pop2.fitness.valid.all())
          and bool(torch.isfinite(pop2.fitness.values).all()))
    phase("main path: GP bench generation (bench_gp.py)", card_line,
          pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          ngen=[GP_NGEN, 2 * GP_NGEN], seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / GP_NGEN for k, v in launches.items()},
          best_mse_start=best0, best_mse_end=best2[-1],
          best_mse_per_gen=best2, mean_length_start=len0,
          mean_length_end=len2, evaluator_backend=pop_ev.last_backend,
          finite_and_shaped=ok)
    if launches["gp_interp"] != GP_NGEN:
        fail(f"K6 ran {launches['gp_interp']} times in {GP_NGEN} GP "
             "generations (once per generation expected)")
    if not best2[-1] < best0:
        fail(f"best MSE did not fall: {best0} -> {best2[-1]}")
    if not ok:
        fail("final GP population is not finite, valid and shaped")

    # the library's loop on the same toolbox
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    final, log = ea_simple(k_ea, pop0, tb, GP_CXPB, GP_MUTPB, GP_EA_GENS,
                           stats=stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    ea_launches = dict(kernels.LAUNCHES)
    mins = log.select("min")
    phase("main path: GP ea_simple", card_line, pop=GP_POP,
          gens=GP_EA_GENS, ms_per_gen=secs / GP_EA_GENS * 1e3,
          launches=ea_launches, best_mse=[float(m) for m in mins],
          valid=bool(final.fitness.valid.all()))
    # one evaluation before the loop (every row valid: all skipped), then
    # one per generation
    if ea_launches["gp_interp"] != GP_EA_GENS + 1:
        fail(f"K6 ran {ea_launches['gp_interp']} times in ea_simple's "
             f"{GP_EA_GENS} generations (expected {GP_EA_GENS + 1})")
    if not bool(final.fitness.valid.all()):
        fail("ea_simple left invalid GP fitness")
    return launches, ea_launches, pop2, pop0, tb


def gp_k6_phase(kernels, card_line, key, pop0, pop2, dev) -> dict:
    """K6 against the plain interpreter at the bench's shapes: the
    initial population, the population after 2N generations, the same
    with every other row skipped, and the every-opcode set; then the
    design's edges: comb trees of exactly ``cap`` tokens at the deepest
    stack (``if`` at depth) at 1024, 1, 1000 and 4097 points (there ``X``
    is too large to stage and goes through L1), the evolved population
    at 4097 points, a single tree, every row skipped, and comb trees of
    256 tokens at cap 256 (a block holds 6 warps, not 8) at 1024 and 4097
    points."""
    import numpy as np
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.probes.gp import comb_trees
    ps, _, _, _, X = gp_toolbox(dev)
    frozen = ps.freeze()
    out = {"initial": k6_check(kernels, card_line, "initial population",
                               frozen, pop0.genome, X),
           "evolved": k6_check(kernels, card_line,
                               f"population after {2 * GP_NGEN} generations",
                               frozen, pop2.genome, X)}
    codes, consts, lengths = pop2.genome
    half = torch.where(torch.arange(GP_POP, device=dev) % 2 == 0, 0, lengths)
    out["skipped"] = k6_check(kernels, card_line,
                              "evolved, every other row skipped", frozen,
                              (codes, consts, half), X)
    ps_all, _, _, gen_all, _ = gp_toolbox(dev, "all")
    frozen_all = ps_all.freeze()

    def two_args(n):
        return torch.stack([torch.linspace(-1, 1, n, device=dev),
                            torch.linspace(3, -2, n, device=dev)])
    trees = gen_all(random.split(key, GP_POP), 2, 6)
    out["all_ops"] = k6_check(kernels, card_line,
                              "every opcode (safe_ops + bool_ops, 2 args)",
                              frozen_all, trees, two_args(GP_NPOINTS))
    comb = comb_trees(ps_all, np.random.default_rng(8), GP_POP, GP_CAP, dev)
    for n in (GP_NPOINTS, 1, 1000, 4097):
        out[f"comb {n}"] = k6_check(
            kernels, card_line, f"comb trees of {GP_CAP} tokens, the deepest "
            f"stack, if at depth, {n} points", frozen_all, comb, two_args(n))
    out["evolved 4097"] = k6_check(
        kernels, card_line, "evolved at 4097 points", frozen, pop2.genome,
        torch.linspace(-1, 1, 4097, device=dev)[None, :])
    out["single"] = k6_check(kernels, card_line, "a single evolved tree",
                             frozen, tuple(g[:1] for g in pop2.genome), X)
    out["all skipped"] = k6_check(kernels, card_line, "every row skipped",
                                  frozen, (codes, consts,
                                           torch.zeros_like(lengths)), X)
    comb256 = comb_trees(ps_all, np.random.default_rng(9), GP_POP, 256, dev)
    for n in (GP_NPOINTS, 4097):
        out[f"comb cap 256 {n}"] = k6_check(
            kernels, card_line, f"comb trees of 256 tokens at cap 256, {n} "
            "points", frozen_all, comb256, two_args(n))
    return out


def profile_gp(key, pop, tb, card_line, gens=3) -> None:
    """``--profile`` for the GP path: the wall cost of each stage of a
    bench generation called alone, then ``torch.profiler`` over
    ``gens`` generations."""
    import torch

    from deap_tpu_torch import random
    from deap_tpu_torch.algorithms import _apply_op, evaluate_population

    n = pop.size
    k_sel, k_var = random.split(key, 3)[1:]
    idx = tb.select(k_sel, pop.fitness, n)
    parents = pop.take(idx)
    n2 = n // 2
    ga = tuple(g[:n2] for g in parents.genome)
    gb = tuple(g[n2:2 * n2] for g in parents.genome)
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "sel_tournament(3, random ties)": lambda: tb.select(
            k_sel, pop.fitness, n),
        "cx_one_point (n/2 pairs)": lambda: _apply_op(tb.mate, k_var, n2,
                                                      ga, gb),
        "mut_uniform (n rows, full 0-2 generator)": lambda: _apply_op(
            tb.mutate, k_var, n, parents.genome),
        "evaluate (K6, all rows)": lambda: evaluate_population(
            tb, parents.with_genome(parents.genome,
                                    torch.ones(n, dtype=torch.bool,
                                               device=idx.device))),
        "whole generation": lambda: gp_generation(tb, key, pop),
    }
    phase("profile: GP stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p, _ = gp_generation(tb, k, p)

    phase("profile: GP bench generation, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# bench_nsga2.py as published (SBX, polynomial mutation, nd="auto") and K5
# ---------------------------------------------------------------------------


def bench_nsga2_toolbox(problem: str):
    """bench_nsga2.py's toolbox for ``BENCH_PROBLEM=problem``."""
    from deap_tpu_torch import base, benchmarks
    from deap_tpu_torch.ops import crossover, mutation
    nobj, ndim = BN_PROBLEMS[problem]
    tb = base.Toolbox()
    if problem == "zdt1":
        tb.register("evaluate", benchmarks.zdt1)
    else:
        tb.register("evaluate", benchmarks.dtlz2, obj=nobj)
    tb.register("mate", crossover.cx_simulated_binary_bounded,
                low=0.0, up=1.0, eta=BN_ETA)
    tb.register("mutate", mutation.mut_polynomial_bounded,
                low=0.0, up=1.0, eta=BN_ETA, indpb=1.0 / ndim)
    return tb


def bench_nsga2_generation(tb, key, pop, select=None):
    """bench_nsga2.py's generation: SBX and polynomial mutation by
    ``vary_genome(pairing="halves")`` on the xla engine, evaluation, the
    (mu + lambda) pool and its environmental selection:
    ``select(k_sel, fitness, n)`` (:func:`bench_select` for
    ``BENCH_SELECT=nsga3 | spea2`` and ``BENCH_STAGED=1``), by default
    ``sel_nsga2(nd="auto", front_chunk=1024)``."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.ops import emo
    n = pop.size
    key, k_var, k_sel = random.split(key, 3)
    genome, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                            pairing="halves")
    off = base.Population(genome, base.Fitness.empty(
        n, pop.fitness.weights, device=genome.device))
    off, _ = evaluate_population(tb, off)
    pool = pop.concat(off)
    if select is None:
        sel = emo.sel_nsga2(k_sel, pool.fitness, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    else:
        sel = select(k_sel, pool.fitness, n)
    return key, pool.take(sel)


def bench_nsga2_initial(tb, key, problem: str, n: int):
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population
    nobj, ndim = BN_PROBLEMS[problem]
    genome = random.uniform(key, (n, ndim))
    pop = base.Population(genome, base.Fitness.empty(
        n, (-1.0,) * nobj, device=key.device))
    return evaluate_population(tb, pop)[0]


def bench_nsga2_reference_phase(card_line, key, problem: str) -> None:
    """One published generation at POP 1024, card against CPU: the
    offspring of ``vary_genome`` bitwise, ``sel_nsga2(nd="auto")`` on the
    CPU pool's values equal, and the grid's (3 objectives) or the
    staircase's (2) ranks equal to the count peel's on the card."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.ops import emo
    dev = torch.device("cuda")
    tb = bench_nsga2_toolbox(problem)
    n = BN_REF_POP
    k_init, k_var, k_sel = random.split(key.cpu(), 3)
    pop = bench_nsga2_initial(tb, k_init, problem, n)
    g_cpu, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                           pairing="halves")
    g_dev, _ = vary_genome(k_var.to(dev), pop.genome.to(dev), tb, BN_CXPB,
                           BN_MUTPB, pairing="halves")
    same_off = torch.equal(g_cpu.view(torch.int32),
                           g_dev.cpu().view(torch.int32))
    off = evaluate_population(tb, base.Population(g_cpu, base.Fitness.empty(
        n, pop.fitness.weights, device="cpu")))[0]
    pool = pop.concat(off)
    pool_dev = base.Fitness(pool.fitness.values.to(dev),
                            pool.fitness.valid.to(dev), pool.fitness.weights)
    idx_cpu = emo.sel_nsga2(k_sel, pool.fitness, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    idx_dev = emo.sel_nsga2(k_sel.to(dev), pool_dev, n, nd="auto",
                            front_chunk=FRONT_CHUNK)
    same_idx = torch.equal(idx_cpu, idx_dev.cpu())
    w = pool_dev.masked_wvalues()
    method = "grid" if w.shape[1] >= 3 else "staircase"
    same_ranks = True
    for stop in (None, n):
        a = emo.nondominated_ranks(w, method=method, front_chunk=FRONT_CHUNK,
                                   stop_at_k=stop)
        b = emo.nondominated_ranks(w, method="peel", front_chunk=FRONT_CHUNK,
                                   stop_at_k=stop)
        same_ranks &= torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    phase(f"reference: bench_nsga2 {problem} generation card vs CPU",
          card_line, pop=n, dim=pop.genome.shape[1], nobj=w.shape[1],
          changed_genes=int((g_cpu != pop.genome).sum().item()),
          offspring_bitwise=same_off, selection_equal=same_idx,
          method=method, ranks_equal_peel=same_ranks)
    if not (same_off and same_idx and same_ranks):
        fail(f"bench_nsga2 {problem} generation on the card differs: "
             f"offspring {same_off}, selection {same_idx}, {method} ranks "
             f"against the peel {same_ranks}")


def _timed_pairs(run, n: int, pairs: int):
    """``pairs`` (N, 2N) timings of ``run(ngen) -> seconds`` in
    alternating order: the median marginal seconds per generation, the
    sorted marginals and the pairs."""
    out = []
    for i in range(pairs):
        if i % 2:
            b, a = run(2 * n), run(n)
        else:
            a, b = run(n), run(2 * n)
        out.append((a, b))
    marginals = sorted((b - a) / n for a, b in out)
    return marginals[len(marginals) // 2], marginals, out


def front_widths(fitness, n_select: int):
    """Widths of the fronts that ``sel_nsga2(nd="auto")`` peels to rank
    ``n_select`` points."""
    import torch
    from deap_tpu_torch.ops import emo
    ranks, nf = emo.nondominated_ranks(
        fitness.masked_wvalues(), method="auto", front_chunk=FRONT_CHUNK,
        stop_at_k=n_select)
    return torch.bincount(ranks.long(), minlength=int(nf))[:int(nf)].tolist()


def bench_nsga2_main_path_a(kernels, card_line, key):
    """Configuration A at full width: the published generation N and 2N
    times in BN_PAIRS pairs, then ``toolbox.hypervolume`` of the final
    population.  Returns the launches of the counted run (2N generations
    and the hypervolume), the final population and the toolbox."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import hv as host_hv, hypervolume as H
    dev = torch.device("cuda")
    tb = bench_nsga2_toolbox("dtlz2")
    ref = HV_REF["dtlz2"]
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, "dtlz2", BN_POP)
    hv0 = tb.hypervolume(-pop0.fitness.wvalues, ref)
    d0 = front_distance(pop0.fitness.values)
    state = {}

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(ngen):
            k, pop = bench_nsga2_generation(tb, k, pop)
        torch.cuda.synchronize()
        state[ngen] = pop
        return time.perf_counter() - t

    run(1)                                     # warm the allocator
    # the counted run: 2N generations, then the hypervolume of what they
    # leave, through the toolbox's default slot
    kernels.reset_launches()
    t2n = run(2 * BN_NGEN)
    pop2 = state[2 * BN_NGEN]
    t = time.perf_counter()
    hv2 = tb.hypervolume(-pop2.fitness.wvalues, ref)
    hv_ms = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(run, BN_NGEN, BN_PAIRS)
    # untimed replay: the widths of the fronts each generation peels
    widths, k, pop = [], k_run, pop0

    def select(k_sel, fitness, n):
        from deap_tpu_torch.ops import emo
        widths.append(front_widths(fitness, n))
        return emo.sel_nsga2(k_sel, fitness, n, nd="auto",
                             front_chunk=FRONT_CHUNK)

    for _ in range(2 * BN_NGEN):
        k, pop = bench_nsga2_generation(tb, k, pop, select=select)
    if not torch.equal(pop.genome, pop2.genome):
        fail("the untimed replay of path A left another population than "
             "the timed run")
    fat = [sum(w >= 4 * FRONT_CHUNK for w in ws) for ws in widths]
    # the value: against the plain float64 sweep on the card, and on a
    # subsample against the host tier
    pts = (-pop2.fitness.wvalues).double()
    plain = float(H.hypervolume_3d(pts, ref))
    sub = pts[::BN_POP // HV_SUBSAMPLE][:HV_SUBSAMPLE]
    sub_card = tb.hypervolume(sub, ref)
    sub_host = host_hv.hypervolume(sub, ref)
    d2 = front_distance(pop2.fitness.values)
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (BN_POP, 12)
                and tuple(final.shape) == (BN_POP, 3)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all())
                and bool(pop2.fitness.valid.all())
                and bool(((pop2.genome >= 0) & (pop2.genome <= 1)).all()))
    rel_plain = abs(hv2 - plain) / abs(plain)
    phase("main path A: bench_nsga2 dtlz2 (SBX, polynomial, grid ranks)",
          card_line, pop=BN_POP, dim=12, nobj=3,
          ngen=[BN_NGEN, 2 * BN_NGEN], seconds=[list(p) for p in pairs],
          counted_run_seconds=t2n, marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / (2 * BN_NGEN) for k, v in launches.items()
                            if k != "hv3d_sweep"},
          fronts_per_gen=[len(ws) for ws in widths], fat_fronts_per_gen=fat,
          widest_front_per_gen=[max(ws) for ws in widths],
          distance_start=d0, distance_end=d2, hv_ref=list(ref),
          hypervolume_start=hv0, hypervolume_end=hv2,
          hypervolume_wall_ms=hv_ms, hypervolume_plain_float64=plain,
          hypervolume_rel_gap_to_plain=rel_plain,
          subsample=HV_SUBSAMPLE, subsample_card=sub_card,
          subsample_host=sub_host, host_tier=host_hv.host_tier(),
          subsample_abs_gap=abs(sub_card - sub_host),
          finite_and_shaped=ok_shape)
    if launches["hv3d_sweep"] != 1:
        fail(f"K5 ran {launches['hv3d_sweep']} times for one "
             "toolbox.hypervolume of path A's population")
    if launches["rows_dominate_counts"] < 1:
        fail("K4 never ran in path A's grid peel")
    if rel_plain > HV_RTOL["float64"]:
        fail(f"path A's hypervolume {hv2} is {rel_plain} (relative) from "
             f"the plain float64 sweep's {plain}")
    if abs(sub_card - sub_host) > 1e-12 * max(1.0, abs(sub_host)):
        fail(f"hypervolume of the {HV_SUBSAMPLE}-point subsample: card "
             f"{sub_card}, host tier ({host_hv.host_tier()}) {sub_host}")
    if not d2 < d0:
        fail(f"DTLZ2 distance did not fall on path A: {d0} -> {d2}")
    if not hv2 > hv0:
        fail(f"the hypervolume did not rise on path A: {hv0} -> {hv2}")
    if not ok_shape:
        fail("path A's final population is not finite, valid, in bounds "
             "and shaped")
    return launches, pop2, tb


def k5_bound(n: int, dtype: str):
    """K5's least time: the four arrays read and one partial per 128
    prefixes written once; n * n pair steps of an integer compare (is the
    slot in the prefix), a maximum of the running height predicated on
    it, and a multiply-add into the area.  The JAX form's running minimum
    needs a subtract and a clamp more a pair step; the running maximum of
    the heights ref_y - y, subtracted once a slot, is the same value
    exactly (kernels/hypervolume.cu), so they are not charged.  In
    float32 the compare and the maximum run at the compare rate and the
    multiply-add at the float32 rate; in float64 the compare at the
    integer rate, the maximum and the multiply-add at the float64 rate."""
    elt = 4 if dtype == "float32" else 8
    n_bytes = (3 * elt + 4) * n + elt * -(-n // 128)
    pairs = float(n) * n
    if dtype == "float32":
        return bound_ms(n_bytes, 2 * pairs, pairs)
    return bound_ms(n_bytes, pairs, 0, 2 * pairs)


def k5_check(kernels, card_line, label: str, points, ref) -> dict:
    """K5 against the plain sweep on one point set, in float32 and
    float64: the total and the slab partials (blocks of 128 prefixes)
    within HV_RTOL of the plain version of the same dtype, two launches
    bitwise equal, and both held against the plain float64 value as the
    truth; kernel, entry (sorts included) and plain times."""
    import torch
    from deap_tpu_torch.ops import hypervolume as H
    n = points.shape[0]
    out = {}
    truth = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        pts = points.to(dtype)
        before = kernels.LAUNCHES["hv3d_sweep"]
        clipped, r = H._as_points(pts, ref)
        ref_y = float(torch.tensor(ref, dtype=dtype)[1])
        part_k = H._hv3d_cuda_partials(clipped, r, ref_y, 128)
        part_k2 = H._hv3d_cuda_partials(clipped, r, ref_y, 128)
        part_p = H._slab_volumes(pts, ref, 128)
        total_k = float(H.hypervolume_3d_cuda(pts, ref))
        total_p = float(H.hypervolume_3d(pts, ref))
        torch.cuda.synchronize()
        if truth is None:
            truth = total_p                     # the float64 plain value
        repeat = torch.equal(part_k.view(torch.uint8).reshape(-1),
                             part_k2.view(torch.uint8).reshape(-1))
        scale = max(abs(total_p), 1e-300)
        rel = abs(total_k - total_p) / scale
        rel_parts = float((part_k.double() - part_p.double()).abs().max()
                          .item()) / scale
        _, ys, zr, dz, width = H._hv3d_prep(clipped, r)
        ys, zr, width, dz = (t.contiguous() for t in (ys, zr, width, dz))
        ms = cuda_ms(lambda: kernels.launch_hv3d_sweep(
            ys, zr, width, dz, ref_y, threads=128), reps=5, warm=1)
        # the device time alone: at small n the host's launch work (four
        # kernels, one scratch allocation) can exceed it
        device_ms = _profile_window(lambda: [kernels.launch_hv3d_sweep(
            ys, zr, width, dz, ref_y, threads=128) for _ in range(5)],
            5)["device_busy_ms"]
        entry_ms = cuda_ms(lambda: H.hypervolume_3d_cuda(pts, ref), reps=3,
                           warm=1)
        plain_ms = cuda_ms(lambda: H.hypervolume_3d(pts, ref), reps=1,
                           warm=0)
        b, by = k5_bound(n, name)
        phase(f"K5 hv3d_sweep vs plain: {label}", card_line, n=n,
              dtype=name, ref=list(ref), kernel=total_k, plain=total_p,
              rel_gap=rel, rel_gap_slab_partials=rel_parts,
              rtol=HV_RTOL[name], bitwise_repeatable=repeat,
              rel_gap_kernel_to_float64_plain=abs(total_k - truth)
              / max(abs(truth), 1e-300),
              rel_gap_plain_to_float64_plain=abs(total_p - truth)
              / max(abs(truth), 1e-300),
              max_abs_err=abs(total_k - total_p), ms=ms,
              device_ms=device_ms, entry_ms=entry_ms, plain_ms=plain_ms,
              bound_ms=b, bound_by=by,
              launches=kernels.LAUNCHES["hv3d_sweep"] - before)
        if not repeat:
            fail(f"K5 {name} on {label}: two launches differ")
        if max(rel, rel_parts) > HV_RTOL[name]:
            fail(f"K5 {name} on {label}: total {rel}, slab partials "
                 f"{rel_parts} (relative to the total) from the plain "
                 f"version, bound {HV_RTOL[name]}")
        out[name] = {"max_abs_err": abs(total_k - total_p), "ms": ms,
                     "device_ms": device_ms, "entry_ms": entry_ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}
    return out


def bench_nsga2_main_path_b(kernels, card_line, key) -> dict:
    """Configuration B at full width: ZDT1, two objectives, staircase
    ranks, the 2-D hypervolume at ref (11, 11) before and after."""
    import torch
    from deap_tpu_torch import random
    tb = bench_nsga2_toolbox("zdt1")
    ref = HV_REF["zdt1"]
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, "zdt1", BN_POP)
    hv0 = tb.hypervolume(-pop0.fitness.wvalues, ref)

    def run(ngen, select=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(ngen):
            k, pop = bench_nsga2_generation(tb, k, pop, select=select)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    secs, pop = run(BN_B_GENS)
    hv1 = tb.hypervolume(-pop.fitness.wvalues, ref)
    launches = dict(kernels.LAUNCHES)
    widths = []

    def select(k_sel, fitness, n):
        from deap_tpu_torch.ops import emo
        widths.append(front_widths(fitness, n))
        return emo.sel_nsga2(k_sel, fitness, n, nd="auto",
                             front_chunk=FRONT_CHUNK)

    _, replay = run(BN_B_GENS, select=select)
    ok = (torch.equal(replay.genome, pop.genome)
          and tuple(pop.genome.shape) == (BN_POP, 30)
          and bool(torch.isfinite(pop.fitness.values).all())
          and bool(pop.fitness.valid.all())
          and bool(((pop.genome >= 0) & (pop.genome <= 1)).all()))
    phase("main path B: bench_nsga2 zdt1 (SBX, polynomial, staircase ranks)",
          card_line, pop=BN_POP, dim=30, nobj=2, gens=BN_B_GENS,
          ms_per_gen=secs / BN_B_GENS * 1e3, launches=launches,
          fronts_per_gen=[len(ws) for ws in widths],
          widest_front_per_gen=[max(ws) for ws in widths],
          best_f1=float(pop.fitness.values[:, 0].min().item()),
          hv_ref=list(ref), hypervolume_start=hv0, hypervolume_end=hv1,
          replay_equal_finite_valid_in_bounds=ok)
    if not hv1 > hv0:
        fail(f"the 2-D hypervolume did not rise on path B: {hv0} -> {hv1}")
    if not ok:
        fail("path B's population is not repeatable, finite, valid and in "
             "bounds")
    return launches


def profile_bench_nsga2(key, pop, tb, card_line, gens=2) -> None:
    """``--profile`` for path A: the wall cost of each stage of a
    published generation called alone (variation with its seven powers
    a gene, evaluation, the grid's views and initial counts, the hybrid
    peel with its rounds by branch, crowding, K5), then
    ``torch.profiler`` over ``gens`` generations."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.algorithms import evaluate_population, vary_genome
    from deap_tpu_torch.base import lexsort
    from deap_tpu_torch.ops import emo, hypervolume as H
    n = pop.size
    k_var, k_sel = random.split(key, 3)[1:]
    genome, _ = vary_genome(k_var, pop.genome, tb, BN_CXPB, BN_MUTPB,
                            pairing="halves")
    off = base.Population(genome, base.Fitness.empty(
        n, pop.fitness.weights, device=genome.device))
    pool = pop.concat(evaluate_population(tb, off)[0])
    w, values = emo._wv_values(pool.fitness)
    ones = torch.ones(2 * n, dtype=torch.bool, device=w.device)
    views = emo._grid_views(w)
    ranks, nf = emo._grid_recount_ranks(w, n, FRONT_CHUNK)
    widths = torch.bincount(ranks.long(), minlength=int(nf))[:int(nf)]
    fat = int((widths >= 4 * FRONT_CHUNK).sum().item())
    dist = emo.assign_crowding_dist(values, ranks)
    pts = -pop.fitness.wvalues
    ga, gb = pop.genome[:n // 2], pop.genome[n // 2:]
    stages = {
        "split key (3)": lambda: random.split(key, 3),
        "vary_genome (SBX + polynomial, 7 pows a gene)": lambda: vary_genome(
            k_var, pop.genome, tb, BN_CXPB, BN_MUTPB, pairing="halves"),
        "  SBX alone (n/2 pairs, 3 pows a gene)": lambda: tb.mate(
            k_var, ga, gb),
        "  polynomial mutation alone (n rows, 4 pows)": lambda: tb.mutate(
            k_var, pop.genome),
        "evaluate (dtlz2, batched form)": lambda: evaluate_population(tb, off),
        "grid views (lexsorts, buckets, slab views)":
            lambda: emo._grid_views(w),
        "initial grid counts (histogram, bands, duplicates)":
            lambda: emo._grid_counts_from_views(views, ones),
        "whole grid ranks (views, counts, hybrid peel)":
            lambda: emo._grid_recount_ranks(w, n, FRONT_CHUNK),
        "crowding distance": lambda: emo.assign_crowding_dist(values, ranks),
        "final sort": lambda: lexsort([-dist, ranks]),
        "whole sel_nsga2(nd=auto)": lambda: emo.sel_nsga2(
            k_sel, pool.fitness, n, nd="auto", front_chunk=FRONT_CHUNK),
        "toolbox.hypervolume (sorts + K5, float64)": lambda: tb.hypervolume(
            pts, HV_REF["dtlz2"]),
        "  hypervolume_3d_cuda float32": lambda: H.hypervolume_3d_cuda(
            pts, HV_REF["dtlz2"]),
    }
    phase("profile: bench_nsga2 A stage wall ms (synchronized, alone)",
          card_line, stages={k: _wall_ms(f, reps=3) for k, f in stages.items()},
          peel_rounds=int(nf), fat_rounds=fat, thin_rounds=int(nf) - fat,
          thin_k4_chunks=int(((widths[widths < 4 * FRONT_CHUNK]
                               + FRONT_CHUNK - 1) // FRONT_CHUNK).sum()))

    def run():
        k, p = key, pop
        for _ in range(gens):
            k, p = bench_nsga2_generation(tb, k, p)

    phase("profile: bench_nsga2 A, per generation", card_line,
          **_profile_window(run, gens))


# ---------------------------------------------------------------------------
# the probe tools: P1-P5 (kernels/probes.cu) and the tools' own paths
# ---------------------------------------------------------------------------

PROBE_POP, PROBE_DIM = 1 << 20, 100           # tools/pallas_probe_ga.py's
PROBE_GP_SETTINGS = ("PROBE_POP", "PROBE_CAP", "PROBE_POINTS", "PROBE_ITERS")
PROBE_RAST_ROWS = (1, 2047, 2048, 2049, (1 << 16) + 96)
PROBE_RAST_DIMS = (0, 1, 31, 32, 33, 37, 96, 100, 127, 128)
PROBE_LOOKUP_NS = (1, 3, 4, 5, 1023, 1 << 20, (1 << 20) + 3)
COS_SWEEP_STRIDE = 7
PROBE_GP_TB = (8, 32)
PROBE_GP_UNROLL = (0, 63)


def probe_check(label: str, card_line, kernel, plain, library, bound,
                exact: bool = False, readings: int = 1, **fields) -> dict:
    """One probe kernel against its plain version on the same inputs:
    bitwise (``exact``: equal integers), times beside the bound and the
    library call's time; fails on a mismatch.  ``readings`` > 1: the
    kernel and the library call are timed that many times in turns, host
    paced and with the launches queued (device time), and the medians
    are kept."""
    import statistics

    import torch
    from deap_tpu_torch.kernels.kernel_times import queued_ms
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if exact:
        gap = 0 if torch.equal(got, want) else 1
        err = float((got.long() - want.long()).abs().max().item())
    else:
        gap = ulp_gap(got, want)
        err = nan_gap(got, want)[1]         # overflowed stacks hold inf
    extra = {}
    if readings > 1:
        calls = {"": kernel, "library_": library} if library else {
            "": kernel}
        times = {f"{k}{t}": [] for k in calls for t in ("ms", "device_ms")}
        for _ in range(readings):
            for k, fn in calls.items():
                times[f"{k}ms"].append(cuda_ms(fn, reps=20, warm=2))
                times[f"{k}device_ms"].append(queued_ms(fn))
        extra = {k: statistics.median(v) for k, v in times.items()}
        ms, library_ms = extra.pop("ms"), extra.pop("library_ms", None)
        extra["readings"] = times
    else:
        ms = cuda_ms(kernel, reps=20, warm=2)
        library_ms = cuda_ms(library, reps=20, warm=2) if library else None
    plain_ms = cuda_ms(plain, reps=1, warm=0)
    b, by = bound
    phase(f"{label} vs plain", card_line, ulp_gap=gap, ulp_bound=ULP_BOUND,
          max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
          bound_ms=b, bound_by=by, **extra, **fields)
    if gap > ULP_BOUND:
        fail(f"{label}: {gap} ulp from its plain version (bound {ULP_BOUND})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b, "bound_by": by,
            **{k: v for k, v in extra.items() if k != "readings"}}


def probe_kernels_phase(card_line, key) -> dict:
    """P1-P4 against their plain versions at the GA tool's shape, 2^20 x
    128 float32 (the reduce masked at dim 100); P3 on the GA tool's
    ``lookup`` table (``permutation(PRNGKey(0), 2^20)``)."""
    import torch
    from deap_tpu_torch import kernels, random
    from deap_tpu_torch.probes import ga as PGA
    pop, dev = PROBE_POP, key.device
    k_x, k_p, k_s = random.split(key, 3)
    x = random.uniform(k_x, (pop, PGA.LANE))
    order = PGA.lookup_table(pop, dev)
    pos = random.randint(k_p, (pop,), 0, pop)
    seed = random.randint(k_s, (1,), -(1 << 31), (1 << 31) - 1)
    copy_out = torch.empty_like(x)
    shape = [pop, PGA.LANE]
    res = {}
    for rows in (512, 2048, 8192):
        res[f"stream_rows{rows}"] = probe_check(
            f"P1 probe_stream_copy rows {rows}", card_line,
            lambda rows=rows: PGA.stream(x, rows), lambda: x.clone(),
            lambda: copy_out.copy_(x), PGA.kernel_bound("stream", pop),
            shape=shape, rows=rows)
        res[f"stream_rows{rows}"]["tb_per_s"] = (
            2 * x.numel() * 4 / res[f"stream_rows{rows}"]["ms"] / 1e9)
    res["chain"] = probe_check(
        "P1 probe_chain24", card_line, lambda: PGA.chain24(x),
        lambda: PGA._chain24_plain(x), None, PGA.kernel_bound("chain", pop),
        shape=shape)
    res["rast"] = probe_check(
        "P1 probe_rast_reduce", card_line,
        lambda: PGA.rast_reduce(x, PROBE_DIM),
        lambda: PGA._rast_reduce_plain(x, PROBE_DIM), None,
        PGA.kernel_bound("rast", pop, PROBE_DIM), readings=3, shape=shape,
        dim=PROBE_DIM)
    rast_edges_phase(card_line, dev)
    cos_sweep_phase(kernels, card_line, dev)
    res["rng"] = probe_check(
        "P2 probe_hash_normal", card_line,
        lambda: PGA.hash_normal(seed, pop),
        lambda: PGA._hash_normal_plain(seed, pop), None,
        PGA.kernel_bound("rng", pop), shape=shape, seed=int(seed.item()))
    # P2's edges: a row, a block's worth of rows less one and more one,
    # under this run's seed and a second one
    gaps = {}
    for s in (seed, torch.tensor([12345], dtype=torch.int32, device=dev)):
        for rows in (1, 2047, 2049):
            gaps[f"seed {int(s.item())}, {rows} rows"] = ulp_gap(
                PGA.hash_normal(s, rows), PGA._hash_normal_plain(s, rows))
    phase("P2 probe_hash_normal edges vs plain", card_line, ulp_gap=gaps,
          ulp_bound=ULP_BOUND)
    if max(gaps.values()) > ULP_BOUND:
        fail(f"P2 probe_hash_normal: edges {gaps} (bound {ULP_BOUND})")
    res["lookup"] = probe_check(
        "P3 probe_lookup", card_line, lambda: PGA.lookup(order, pos),
        lambda: order[pos.long()], lambda: order[pos],
        PGA.kernel_bound("lookup", pop), exact=True, readings=5,
        queries=pop)
    lookup_edges_phase(card_line, dev)
    res["dmagather"] = probe_check(
        "P4 probe_row_gather", card_line,
        lambda: PGA.row_gather(x, pos), lambda: x[pos.long()],
        lambda: torch.index_select(x, 0, pos),
        PGA.kernel_bound("dmagather", pop), shape=shape)
    del x, order, pos, copy_out
    torch.cuda.empty_cache()
    return res


def rast_edges_phase(card_line, dev) -> None:
    """P1's reduce bitwise to its plain version at ragged row counts and
    every kind of mask (dims up to 96 leave the fourth window empty), on
    rows that put warps on the branch-free cosine, on the general one and
    on both (``probes.ga.rast_inputs``: one lane outside the range, rows
    wholly outside it, NaN and +-inf)."""
    import torch
    from deap_tpu_torch.probes import ga as PGA
    gaps, nan_rows = {}, 0
    for n_rows in PROBE_RAST_ROWS:
        x = PGA.rast_inputs(n_rows, dev)
        for dim in PROBE_RAST_DIMS:
            got = PGA.rast_reduce(x, dim)
            want = PGA._rast_reduce_plain(x, dim)
            gaps[f"{n_rows} x {dim}"] = ulp_gap(got, want)
            nan_rows += int(torch.isnan(want).sum().item())
    phase("P1 probe_rast_reduce edges vs plain", card_line,
          rows=list(PROBE_RAST_ROWS), dims=list(PROBE_RAST_DIMS),
          worst_ulp_gap=max(gaps.values()), nan_rows=nan_rows,
          ulp_bound=ULP_BOUND)
    if max(gaps.values()) > ULP_BOUND:
        fail(f"P1 probe_rast_reduce edges: "
             f"{ {k: v for k, v in gaps.items() if v} } (bound {ULP_BOUND})")


def cos_sweep_phase(kernels, card_line, dev) -> None:
    """The branch-free cosine of P1 and P2 (``cos_reduced``) against
    ``xla_sincos(y, true)`` on every COS_SWEEP_STRIDE-th float32 of its
    range, |y| < 120 of either sign (the card test sweeps every one);
    any mismatch fails the run."""
    found = {}
    t0 = time.perf_counter()
    for sign, lo in (("positive", 0), ("negative", 0x80000000)):
        found[sign] = kernels._cos_reduced_mismatches(
            lo, lo + 0x42F00000, COS_SWEEP_STRIDE, dev)
    phase("P1/P2 cos_reduced vs xla_sincos, strided sweep", card_line,
          stride=COS_SWEEP_STRIDE, mismatches=found,
          seconds=time.perf_counter() - t0)
    if any(count for count, _ in found.values()):
        fail(f"cos_reduced differs from xla_sincos: {found}")


def lookup_edges_phase(card_line, dev) -> None:
    """P3 exactly ``order[pos]`` at ragged query counts, a table of another
    size, positions 0 and m - 1, and ``pos`` 0-3 words into its
    allocation (``probes.ga.lookup_inputs``)."""
    import torch
    from deap_tpu_torch.probes import ga as PGA
    bad = []
    for n in PROBE_LOOKUP_NS:
        for offset in range(4):
            order, pos = PGA.lookup_inputs(n, offset, dev)
            if not torch.equal(PGA.lookup(order, pos), order[pos.long()]):
                bad.append((n, offset))
    phase("P3 probe_lookup edges vs plain", card_line,
          queries=list(PROBE_LOOKUP_NS), offsets=[0, 1, 2, 3], mismatched=bad)
    if bad:
        fail(f"P3 probe_lookup differs from order[pos] at {bad}")


def probe_ga_tool_phase(kernels, card_line) -> dict:
    """The GA probe tool's own path at 2^20 x 100: every probe,
    ``--recommend``, ``--json chip_smoke_out/probe_ga.json``; P1-P4 must run
    on it, every record must carry a finite time above zero, ``varveval``
    must record both key implementations and nothing may err."""
    import math
    from deap_tpu_torch.probes import ga as PGA
    out_dir = os.path.join(ROOT, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    kernels.reset_launches()
    doc = PGA.main(["--pop", str(PROBE_POP), "--dim", str(PROBE_DIM),
                    "--recommend", "--json",
                    os.path.join(out_dir, "probe_ga.json")])
    launches = dict(kernels.LAUNCHES)
    res = doc["result"]
    bad = [r["probe"] for r in res["probes"]
           if not (isinstance(r["ms"], float) and math.isfinite(r["ms"])
                   and r["ms"] > 0)]
    errors = res["errors"]
    recorded = [r["probe"] for r in res["probes"]]
    phase("probe tool: deap_tpu_torch.probes.ga", card_line,
          pop=res["pop"], dim=res["dim"], k_iters=res["k_iters"],
          ms={r["probe"]: r["ms"] for r in res["probes"]},
          linearity={r["probe"]: r["linearity_t2k_over_tk"]
                     for r in res["probes"]},
          errors=errors, recommend=res["recommend"],
          launches={k: v for k, v in launches.items() if v})
    if bad:
        fail(f"probe records without a finite positive time: {bad}")
    if errors:
        fail(f"the GA probe tool reported errors: {errors}")
    for name in ("torch_varveval_threefry2x32", "torch_varveval_rbg"):
        if name not in recorded:
            fail(f"the GA probe tool did not record {name}")
    for name in ("probe_stream_copy", "probe_chain24", "probe_rast_reduce",
                 "probe_hash_normal", "probe_lookup", "probe_row_gather"):
        if not launches[name]:
            fail(f"{name} did not run on the GA probe tool's path")
    return launches


def probe_gp_phase(card_line, key) -> dict:
    """P5 against its plain version, bitwise, on the GP tool's 4096 x 64
    full binary trees at 1024 points: every mode, tb 8 and 32, unroll 1
    and 63; then on its edges, every form.  Returns the forms' results
    and the edges' largest error."""
    import numpy as np
    import torch
    from deap_tpu_torch.probes import gp as PGP
    pop, cap, npts = GP_POP, GP_CAP, GP_NPOINTS
    codes, consts, lengths = PGP.full_binary_trees(
        PGP.bench_pset(), np.random.default_rng(0), pop, cap, key.device)
    x = torch.zeros((1, 1), device=key.device)
    res = {}
    for mode in ("noswitch", "dispatch", "stackrw"):
        for tb in PROBE_GP_TB:
            for unroll in PROBE_GP_UNROLL:
                run = PGP.make_probe_kernel(mode, 9, tb, unroll,
                                            n_points=npts)
                res[(mode, tb, unroll)] = probe_check(
                    f"P5 probe_gp {mode} tb {tb} unroll {unroll or 1}",
                    card_line, lambda run=run: run(codes, consts, lengths, x),
                    lambda mode=mode, tb=tb, unroll=unroll:
                    PGP._probe_gp_plain(codes, consts, lengths, npts, mode,
                                        tb, bool(unroll), 9),
                    None, PGP.probe_bound(mode, codes, npts),
                    shape=[pop, cap, npts])
    # P5's edges (probes.gp.probe_edges): groups with missing trees, ragged
    # and single points, cap 256, codes outside the branches; every form
    edge_err = 0.0
    for name, (c, k, ln, n_points, nb) in PGP.probe_edges(key.device).items():
        gaps = {}
        for mode in ("noswitch", "dispatch", "stackrw"):
            for tb in PROBE_GP_TB:
                for unroll in PROBE_GP_UNROLL:
                    got = PGP.make_probe_kernel(mode, nb, tb, unroll,
                                                n_points=n_points)(c, k, ln, x)
                    want = PGP._probe_gp_plain(c, k, ln, n_points, mode, tb,
                                               bool(unroll), nb)
                    gaps[f"{mode} tb {tb} unroll {unroll or 1}"] = ulp_gap(
                        got, want)
                    edge_err = max(edge_err, nan_gap(got, want)[1])
        phase(f"P5 probe_gp edge vs plain: {name}", card_line,
              shape=[*c.shape, n_points], n_branches=nb, ulp_gap=gaps,
              ulp_bound=ULP_BOUND)
        if max(gaps.values()) > ULP_BOUND:
            fail(f"P5 probe_gp, {name}: {gaps} (bound {ULP_BOUND})")
    return res, edge_err


def probe_gp_tool_phase(kernels, card_line) -> tuple:
    """The GP probe tool's nine probes at its defaults (4096 x 64 x 1024);
    P5 and K6 (``real63``) must run on it."""
    import math
    from deap_tpu_torch.probes import gp as PGP
    for name in PROBE_GP_SETTINGS:
        os.environ.pop(name, None)
    kernels.reset_launches()
    out = PGP.main([])
    launches = dict(kernels.LAUNCHES)
    pr = out["probes"]
    phase("probe tool: deap_tpu_torch.probes.gp", card_line,
          shape=out["shape"],
          ns_per_token={k: v["ns_per_token"] for k, v in pr.items()},
          eval_ms={k: v["eval_ms"] for k, v in pr.items()},
          linearity={k: v["linearity"] for k, v in pr.items()},
          fraction_of_floor=out.get("fraction_of_floor"),
          launches={k: v for k, v in launches.items() if v})
    bad = [k for k, v in pr.items()
           if not (math.isfinite(v["eval_ms"]) and v["eval_ms"] > 0)]
    if bad or sorted(pr) != sorted(PGP.PROBES):
        fail(f"GP probe records missing or without a finite positive "
             f"time: {bad or sorted(set(PGP.PROBES) - set(pr))}")
    if not math.isfinite(out.get("fraction_of_floor", float("nan"))):
        fail("the GP probe tool gave no finite fraction_of_floor")
    for name in ("probe_gp", "gp_interp"):
        if not launches[name]:
            fail(f"{name} did not run on the GP probe tool's path")
    return launches, out


# ---- 22.-25. the OneMax and CMA-ES slices (BASELINE configs 1 and 3) --------

# BASELINE config 1 (bench_onemax.py): pop 300 x 100 bits, cx_two_point,
# mut_flip_bit(0.05), sel_tournament(3), cxpb 0.5, mutpb 0.2
OM_POP, OM_BITS, OM_NGEN, OM_CXPB, OM_MUTPB = 300, 100, 40, 0.5, 0.2
OM_TIMING_NGEN, OM_PAIRS = 20, 3
# BASELINE config 3 (bench_cma.py): N = 100, lambda = 4096, centroid 5, sigma 5
CMA_DIM, CMA_LAMBDA, CMA_WARM, CMA_TIMING_NGEN, CMA_PAIRS = 100, 4096, 5, 10, 3
CMA_RTOL = 1e-4          # card vs CPU, relative to a field's largest value
CMA_B_ATOL = 1e-2        # |B_cardᵀ B_cpu| = I up to column signs
CMA_HSIG_MARGIN = 1e-4   # pc and C are compared only beyond this margin
MO_HV_THRESHOLD = 116.0  # tests/test_algorithms.py:15


def onemax_toolbox():
    from deap_tpu_torch import base
    from deap_tpu_torch.ops import crossover, mutation, selection
    import torch
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def onemax_run(dev, ngen: int, impl: str = "threefry2x32"):
    """``ea_simple`` at BASELINE config 1 with ``HallOfFame(1)`` and
    max / avg statistics from ``PRNGKey(0)`` of ``impl`` on ``dev``."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch._xla_math import row_mean
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.utils.support import HallOfFame, Statistics
    key = random.PRNGKey(0, impl=impl, device=dev)
    genome = random.bernoulli(key, 0.5, (OM_POP, OM_BITS)).float()
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)
    pop = base.Population(genome, base.Fitness.empty(OM_POP, (1.0,),
                                                     device=dev))
    pop, log = ea_simple(key, pop, onemax_toolbox(), OM_CXPB, OM_MUTPB, ngen,
                         stats=stats, halloffame=hof)
    return pop, log, hof


def onemax_phase(card_line, impl: str = "threefry2x32") -> None:
    import torch
    from deap_tpu_torch import kernels
    dev = torch.device("cuda")
    kernels.reset_launches()
    pop, log, hof = onemax_run(dev, OM_NGEN, impl)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cpop, clog, chof = onemax_run(torch.device("cpu"), OM_NGEN, impl)
    same = {
        "genome": torch.equal(pop.genome.cpu(), cpop.genome),
        "values": torch.equal(pop.fitness.values.cpu(), cpop.fitness.values),
        "logbook": all(log.select(c) == clog.select(c)
                       for c in ("gen", "nevals", "max", "avg")),
        "archive": (torch.equal(hof.state.genome.cpu(), chof.state.genome)
                    and torch.equal(hof.state.values.cpu(),
                                    chof.state.values)
                    and torch.equal(hof.state.filled.cpu(),
                                    chof.state.filled))}
    best = log.select("max")
    reached = next((g for g, m in zip(log.select("gen"), best)
                    if m == OM_BITS), None)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        onemax_run(dev, ngen, impl)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    per_gen, marginals, pairs = _timed_pairs(run, OM_TIMING_NGEN, OM_PAIRS)
    phase(f"OneMax ea_simple + HallOfFame(1) (BASELINE config 1), {impl}",
          card_line, key_impl=impl,
          pop=OM_POP, bits=OM_BITS, ngen=OM_NGEN, card_equals_cpu=same,
          max_start=best[0], max_end=best[-1], gen_max_reaches_100=reached,
          hof_best=float(hof.state.values[0, 0]),
          timing_ngen=[OM_TIMING_NGEN, 2 * OM_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          launches=launches)
    if not all(same.values()):
        fail(f"OneMax card vs CPU differ: {same}")
    if not best[-1] > best[0] or hof.state.values[0, 0] != max(best):
        fail(f"OneMax did not improve or the archive missed the best: "
             f"{best[0]} -> {best[-1]}, hof {hof.state.values[0, 0]}")


def cma_toolbox(strategy, fn: str):
    from deap_tpu_torch import base, benchmarks
    tb = base.Toolbox()
    tb.register("evaluate", getattr(benchmarks, fn))
    tb.register("generate", strategy.generate)
    tb.register("update", strategy.update)
    return tb


def _rel(a, b) -> float:
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _hsig_margin(strategy, state) -> float:
    import math
    lhs = (float(state.ps.double().norm())
           / math.sqrt(1 - (1 - strategy.cs) ** (2 * int(state.update_count)))
           / strategy.chiN)
    return abs(lhs - (1.4 + 2.0 / (strategy.dim + 1.0)))


def _state_to(state, dev):
    import dataclasses
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state)})


def eigh_on_card(C) -> dict:
    """``torch.linalg.eigh`` of ``C`` under the profiler (the device
    kernels it ran, their time a call over five calls) and its
    host-clock ms a call, the host synchronisation on its ``info``
    included.  A window in which the profiler recorded no device
    activity at all is taken again, up to three times (a short window
    has come back empty on the card)."""
    import torch
    w, B = torch.linalg.eigh(C)
    for _ in range(3):
        prof = _profile_window(
            lambda: [torch.linalg.eigh(C) for _ in range(5)], gens=5)
        if prof["kernel_launches"]:
            break
    return {"on_card": bool(w.is_cuda and B.is_cuda),
            "device_ms": prof["device_busy_ms"],
            "kernel_launches": prof["kernel_launches"],
            "kernels": [k["kernel"] for k in prof["top_kernels"]],
            "wall_ms": _wall_ms(lambda: torch.linalg.eigh(C), reps=20)}


def cma_phase(card_line, fn: str, impl: str = "threefry2x32") -> None:
    """BASELINE config 3 on ``fn`` from ``PRNGKey(0)`` of ``impl``: a
    teacher-forced step card vs CPU, the marginal ms of
    ``ea_generate_update`` and ``eigh``'s share."""
    import torch
    from deap_tpu_torch import base, cma, kernels, random
    from deap_tpu_torch.algorithms import ea_generate_update, \
        evaluate_population
    from deap_tpu_torch.utils.support import Statistics
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("TF32 is on: the CMA-ES products must run in full float32")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    s = cma.Strategy(centroid=[5.0] * CMA_DIM, sigma=5.0, lambda_=CMA_LAMBDA,
                     device=dev)
    sc = cma.Strategy(centroid=[5.0] * CMA_DIM, sigma=5.0,
                      lambda_=CMA_LAMBDA, device=cpu)
    tb = cma_toolbox(s, fn)
    key = random.PRNGKey(0, impl=impl, device=dev)
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    kernels.reset_launches()
    pop, state, log = ea_generate_update(key, tb, s.init(), CMA_WARM,
                                         weights=(-1.0,), stats=stats)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)

    # one step teacher-forced: the same state, key and population
    k = random.fold_in(key, 99)
    g_card = s.generate(state, k)
    g_cpu = sc.generate(_state_to(state, cpu), k.cpu())
    pop = base.Population(g_card, base.Fitness.empty(CMA_LAMBDA, (-1.0,),
                                                     device=dev))
    pop, _ = evaluate_population(tb, pop)
    nxt = s.update(state, pop)
    nxt_cpu = sc.update(_state_to(state, cpu), base.Population(
        pop.genome.cpu(), base.Fitness(pop.fitness.values.cpu(),
                                       pop.fitness.valid.cpu(), (-1.0,))))
    margin = _hsig_margin(sc, nxt_cpu)
    fields = ["centroid", "sigma", "ps", "diagD"] + (
        ["pc", "C"] if margin > CMA_HSIG_MARGIN else [])
    errs = {"genome": _rel(g_card, g_cpu)}
    errs.update({f: _rel(getattr(nxt, f), getattr(nxt_cpu, f))
                 for f in fields})
    cross = (nxt.B.cpu().T @ nxt_cpu.B).abs()
    errs["B_up_to_sign"] = float((cross - torch.eye(CMA_DIM)).abs().max())
    flipped = int((torch.diagonal(nxt.B.cpu().T @ nxt_cpu.B) < 0).sum())

    eig = eigh_on_card(nxt.C)

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ea_generate_update(key, tb, s.init(), ngen, weights=(-1.0,))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run(2)
    per_gen, marginals, pairs = _timed_pairs(run, CMA_TIMING_NGEN, CMA_PAIRS)
    prof = _profile_window(lambda: run(CMA_TIMING_NGEN), CMA_TIMING_NGEN)
    best = log.select("min")
    fit = pop.fitness.values
    phase(f"CMA-ES ea_generate_update {fn} (BASELINE config 3), {impl}",
          card_line, key_impl=impl, dim=CMA_DIM, lambda_=CMA_LAMBDA, warm_gens=CMA_WARM,
          teacher_forced_rel_err=errs, rtol=CMA_RTOL, b_atol=CMA_B_ATOL,
          hsig_margin=margin, b_columns_flipped=flipped,
          eigh=eig, tf32=torch.backends.cuda.matmul.allow_tf32,
          matmul_precision=torch.get_float32_matmul_precision(),
          timing_ngen=[CMA_TIMING_NGEN, 2 * CMA_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          eigh_share_of_gen=eig["wall_ms"] / (per_gen * 1e3),
          profile_one_gen=prof, best_start=best[0], best_end=best[-1],
          sigma=float(nxt.sigma), launches=launches)
    bad = {f: e for f, e in errs.items()
           if e > (CMA_B_ATOL if f == "B_up_to_sign" else CMA_RTOL)}
    if bad:
        fail(f"CMA-ES {fn} card vs CPU beyond tolerance: {bad}")
    if not eig["on_card"] or not eig["kernel_launches"]:
        fail(f"eigh did not run on the card: {eig}")
    if not bool(torch.isfinite(fit).all()) or \
            tuple(pop.genome.shape) != (CMA_LAMBDA, CMA_DIM):
        fail(f"CMA-ES {fn}: population not finite or misshaped")


def cma_anchor_phase(card_line) -> None:
    """Verify flow 2 (sphere, N = 5, lambda 20, 100 generations) and the
    (1+lambda) anchor (N = 5, lambda 8, 300 generations) on the card."""
    import torch
    from deap_tpu_torch import cma, kernels, random
    from deap_tpu_torch.algorithms import ea_generate_update
    dev = torch.device("cuda")
    kernels.reset_launches()
    s = cma.Strategy(centroid=[5.0] * 5, sigma=5.0, lambda_=20, device=dev)
    t = time.perf_counter()
    pop, state, log = ea_generate_update(
        random.PRNGKey(0, device=dev), cma_toolbox(s, "sphere"), s.init(),
        ngen=100, weights=(-1.0,))
    best = float(pop.fitness.values.min())
    t_flow2 = time.perf_counter() - t
    s1 = cma.StrategyOnePlusLambda(parent=[3.0] * 5, sigma=1.0,
                                   weights=(-1.0,), lambda_=8, device=dev)
    t = time.perf_counter()
    _, st1, _ = ea_generate_update(
        random.PRNGKey(10, device=dev), cma_toolbox(s1, "sphere"), s1.init(),
        ngen=300, weights=(-1.0,))
    best1 = -float(st1.parent_wvalues[0])
    t_opl = time.perf_counter() - t
    phase("CMA-ES anchors: verify flow 2 and (1+lambda)", card_line,
          flow2_best=best, flow2_seconds=t_flow2, flow2_gens=len(log),
          one_plus_lambda_best=best1, one_plus_lambda_seconds=t_opl,
          one_plus_lambda_A_on_card=bool(st1.A.is_cuda),
          launches=dict(kernels.LAUNCHES))
    if not best < 1e-8:
        fail(f"CMA-ES flow 2 best {best} is not below 1e-8")
    if not best1 < 1e-3:
        fail(f"(1+lambda) best {best1} is not below 1e-3")


def mo_cma_phase(card_line) -> None:
    """MO-CMA-ES on ZDT1 as tests/test_algorithms.py:178 runs it (MU =
    LAMBDA = 10, 500 generations, RandomState(128)) on the card; the
    device and host selection routes on every generation's candidates."""
    import numpy as np
    import torch
    from deap_tpu_torch import benchmarks, cma, kernels, random
    from deap_tpu_torch.ops.hv import hypervolume
    dev = torch.device("cuda")

    def evaluate(genomes):
        g = np.asarray(genomes, np.float64)
        f = np.clip(g, 0.0, 1.0)
        vals = torch.stack(benchmarks.zdt1(
            torch.as_tensor(f, dtype=torch.float32, device=dev)), 1)
        pen = 1e7 * np.sum((f - g) ** 2, axis=1)
        return vals.double().cpu().numpy() + pen[:, None]

    kernels.reset_launches()
    pop = np.random.RandomState(128).rand(10, 5)
    s = cma.StrategyMultiObjective(pop, (-1.0, -1.0), sigma=1.0,
                                   values=evaluate(pop), mu=10, lambda_=10,
                                   device=dev)
    key = random.PRNGKey(128, device=dev)
    disagree, t_dev, t_host = 0, 0.0, 0.0
    t0 = time.perf_counter()
    for _ in range(500):
        key, k = random.split(key)
        off = s.generate(k)
        vals = evaluate(off)
        genomes = np.concatenate([off, s.parents])
        values = np.concatenate([vals, s.parent_values])
        t = time.perf_counter()
        dev_pick = s._select(genomes, values, None)
        t_dev += time.perf_counter() - t
        s.select_backend = "host"
        t = time.perf_counter()
        host_pick = s._select(genomes, values, None)
        t_host += time.perf_counter() - t
        s.select_backend = "auto"
        if dev_pick[0] != host_pick[0] or \
                set(dev_pick[1]) != set(host_pick[1]):
            disagree += 1
        s.update(off, vals)
    seconds = time.perf_counter() - t0
    hv = hypervolume(s.parent_values, [11.0, 11.0])
    feasible = bool(np.all(s.parents >= -1e-5) and np.all(s.parents
                                                          <= 1 + 1e-5))
    phase("MO-CMA-ES ZDT1 (tests/test_algorithms.py:178)", card_line,
          mu=10, lambda_=10, ngen=500, hypervolume=hv,
          threshold=MO_HV_THRESHOLD, feasible=feasible,
          select_routes_disagree=disagree, seconds=seconds,
          device_select_ms=t_dev / 500 * 1e3,
          host_select_ms=t_host / 500 * 1e3,
          launches=dict(kernels.LAUNCHES))
    if disagree:
        fail(f"device and host MO-CMA selection differ on {disagree} "
             "generations")
    if not hv > MO_HV_THRESHOLD or not feasible:
        fail(f"MO-CMA-ES hypervolume {hv} <= {MO_HV_THRESHOLD} or "
             "parents outside [0, 1]")


# ---------------------------------------------------------------------------
# the rbg key implementation, and the paths that default to it
# ---------------------------------------------------------------------------

RBG_DRAWS = 1 << 20
RBG_BATCH = 4096                   # keys of an (n, 4) batch
RBG_TIME_DRAWS = 10 ** 6
# jax.random.bits(key, (n,)) of raw rbg keys on jax 0.9.0's CPU backend
RBG_GOLDEN = (
    ((0, 0, 0, 0), (1713891541, 3781805453, 3159862348, 2600524760)),
    ((1, 2, 3, 4), (512747620, 1298009047, 1267190206)),
    ((0xDEADBEEF, 0x12345678, 0xFFFFFFFF, 0xFFFFFFFE),
     (65559129, 1930409553, 648285888)))
RBG_NGEN, RBG_PAIRS = 10, 3
RBG_REF_POP, RBG_REF_GENS = 10_240, 3      # a multiple of the rows a tile
# evopole: bench_evopole.py's defaults (examples/ga/evopole.py's constants)
EVO_REF_GENS = 3
EVO_TIMING_NGEN, EVO_PAIRS = 2, 2
EVO_RISE_GENS = 5
EVO_PROFILE_STEPS = 50


def _bits_of(t):
    """A tensor's bit pattern on the host, for bitwise comparisons."""
    import torch
    t = t.detach().cpu()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


def _same_bits(a, b) -> bool:
    import torch
    a, b = _bits_of(a), _bits_of(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def rbg_phase(card_line) -> dict:
    """The rbg key implementation on the card: the golden words, and every
    key function and sampler at 2^20 draws, from one key and from an
    ``(n, 4)`` batch, against the CPU's bit for bit; the ms of 1e6
    uniforms under rbg and threefry."""
    import torch
    from deap_tpu_torch import random
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    golden = {str(list(w)): random.bits(torch.tensor(w, dtype=torch.int64,
                                                     device=dev),
                                        (len(want),)).tolist() == list(want)
              for w, want in RBG_GOLDEN}
    key = random.PRNGKey(0, impl="rbg", device=dev)
    batch = random.split(random.fold_in(key, 1), RBG_BATCH)
    per_key = RBG_DRAWS // RBG_BATCH
    funcs = {
        "split": lambda k, n: random.split(k, 3),
        "fold_in": lambda k, n: random.fold_in(k, 7),
        "bits": lambda k, n: random.bits(k, (n,)),
        "uniform": lambda k, n: random.uniform(k, (n,), minval=-5.12,
                                               maxval=5.12),
        "normal": lambda k, n: random.normal(k, (n,)),
        "normal_bfloat16": lambda k, n: random.normal(k, (n,),
                                                      torch.bfloat16),
        "bernoulli": lambda k, n: random.bernoulli(k, 0.3, (n,)),
        "randint": lambda k, n: random.randint(k, (n,), -50, 1_000_003),
    }
    equal = {}
    for name, f in funcs.items():
        for label, k, n in (("key", key, RBG_DRAWS),
                            ("batch", batch, per_key)):
            equal[f"{name} {label}"] = _same_bits(f(k, n), f(k.to(cpu), n))
    ms = {impl: cuda_ms(lambda impl=impl: random.uniform(
              random.PRNGKey(3, impl=impl, device=dev), (RBG_TIME_DRAWS,)))
          for impl in ("rbg", "threefry2x32")}
    phase("rbg: keys and samplers card vs CPU, golden words", card_line,
          draws=RBG_DRAWS, batch=[RBG_BATCH, 4], golden=golden,
          card_equals_cpu=equal,
          uniform_ms_1e6={"rbg": ms["rbg"], "threefry2x32":
                          ms["threefry2x32"]})
    if not all(golden.values()):
        fail(f"rbg bits differ from jax's golden words: {golden}")
    bad = [k for k, v in equal.items() if not v]
    if bad:
        fail(f"rbg on the card differs from the CPU: {bad}")
    return ms


def flagship_rbg_phase(kernels, card_line) -> dict:
    """The flagship under rbg keys (``bench.py``'s default): ``ea_simple``
    with the megakernel engine on rastrigin at 1e6 x 100 float32 from
    ``PRNGKey(0, impl="rbg")``, N and 2N generations, three pairs; K2
    once a generation; the best fitness must fall.  Then three
    generations at 10240 x 100, teacher-forced card against CPU (offspring
    bitwise, fitness within rtol 1e-5: rastrigin's sum runs in each
    device's order), and the live-mask ``ea_step`` with K1 counted."""
    import torch
    from deap_tpu_torch import base, benchmarks, random
    from deap_tpu_torch.algorithms import ea_simple, ea_step
    from deap_tpu_torch.ops import crossover, mutation, selection
    from deap_tpu_torch.utils.support import Statistics
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    key = random.PRNGKey(0, impl="rbg", device=dev)
    k_init, k_run, k_ref, k_live = random.split(key, 4)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)

    def run(ngen):
        pop0 = base.Population(genome.clone(), base.Fitness.empty(
            POP, (-1.0,), device=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_simple(k_run, pop0, tb, CXPB, MUTPB, ngen, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(2)
    kernels.reset_launches()
    _, pop, log = run(RBG_NGEN)
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(lambda n: run(n)[0], RBG_NGEN,
                                             RBG_PAIRS)
    best = log.select("min")

    # teacher-forced generations at 1e4 x 100, card against CPU
    small = base.Population(genome[:RBG_REF_POP].clone(), base.Fitness.empty(
        RBG_REF_POP, (-1.0,), device=dev))
    from deap_tpu_torch.algorithms import evaluate_population
    small, _ = evaluate_population(tb, small)
    k, ref = k_ref, []
    for _ in range(RBG_REF_GENS):
        host = base.Population(small.genome.cpu(), base.Fitness(
            small.fitness.values.cpu(), small.fitness.valid.cpu(), (-1.0,)))
        k_next, nxt, _ = ea_step(k, small, tb, CXPB, MUTPB)
        _, nxt_cpu, _ = ea_step(k.cpu(), host, tb, CXPB, MUTPB)
        ref.append({"genome": _same_bits(nxt.genome, nxt_cpu.genome),
                    "fitness_rel_err": _rel(nxt.fitness.values,
                                            nxt_cpu.fitness.values)})
        k, small = k_next, nxt

    live = torch.arange(POP, device=dev) < POP - 4096
    kernels.reset_launches()
    skey, spop = k_live, pop
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LIVE_GENS):
        skey, spop, _ = ea_step(skey, spop, tb, CXPB, MUTPB, live=live)
    torch.cuda.synchronize()
    t_live = time.perf_counter() - t
    launches_live = dict(kernels.LAUNCHES)
    frozen = torch.equal(spop.genome[~live], pop.genome[~live])
    phase("flagship under rbg: ea_simple megakernel rastrigin", card_line,
          key_impl="rbg", pop=POP, dim=DIM, ngen=[RBG_NGEN, 2 * RBG_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          best_start=best[0], best_end=best[-1], launches=launches,
          teacher_forced_card_vs_cpu=ref, reference_pop=RBG_REF_POP,
          live_gens=LIVE_GENS, live_ms_per_gen=t_live / LIVE_GENS * 1e3,
          launches_live=launches_live, pad_rows_frozen=frozen)
    if launches["megakernel_gather_vary"] != RBG_NGEN:
        fail(f"K2 ran {launches['megakernel_gather_vary']} times in "
             f"{RBG_NGEN} generations under rbg keys")
    if not best[-1] < best[0]:
        fail(f"rbg flagship: best fitness did not fall: {best}")
    if not all(r["genome"] and r["fitness_rel_err"] <= 1e-5 for r in ref):
        fail(f"rbg flagship: card and CPU generations differ: {ref}")
    if launches_live["megakernel_vary"] != LIVE_GENS or not frozen:
        fail(f"rbg live-mask step: K1 ran "
             f"{launches_live['megakernel_vary']} times, pads frozen "
             f"{frozen}")
    return {"K2": launches["megakernel_gather_vary"],
            "K1": launches_live["megakernel_vary"]}


def evopole_setup(dev, masked: bool = False):
    """``bench_evopole.py``'s set-up on ``dev``: ``PRNGKey(0)`` under rbg
    split into the loop key, the initial population's and the episodes';
    blend crossover, Gaussian weight mutation, ``sel_tournament(3)``."""
    from deap_tpu_torch import base, random
    from deap_tpu_torch.examples.ga import evopole as EV
    from deap_tpu_torch.ops import selection
    key = random.PRNGKey(0, impl="rbg", device=dev)
    key, k_init, k_eps = random.split(key, 3)
    tb = base.Toolbox()
    tb.register("evaluate", EV.make_evaluate(
        random.split(k_eps, EV.N_EPISODES), masked=masked))
    tb.register("mate", EV.mate_blend)
    tb.register("mutate", EV.mut_gaussian_tree)
    tb.register("select", selection.sel_tournament, tournsize=3)
    pop = base.Population(EV.init_population(k_init, EV.POP),
                          base.Fitness.empty(EV.POP, (1.0,), device=dev))
    return key, pop, tb


def evopole_run(dev, ngen: int):
    """``ea_simple`` at BASELINE config 5 with max / avg statistics and
    ``HallOfFame(1)``, as the example's ``main`` runs it."""
    import torch
    from deap_tpu_torch._xla_math import row_mean
    from deap_tpu_torch.algorithms import ea_simple
    from deap_tpu_torch.examples.ga import evopole as EV
    from deap_tpu_torch.utils.support import HallOfFame, Statistics
    key, pop, tb = evopole_setup(dev)
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("avg", row_mean)
    hof = HallOfFame(1)
    pop, log = ea_simple(key, pop, tb, EV.CXPB, EV.MUTPB, ngen, stats=stats,
                         halloffame=hof)
    return pop, log, hof


def evopole_phase(kernels, card_line) -> dict:
    """BASELINE config 5 at ``bench_evopole.py``'s defaults (pop 256, 4
    episodes of at most 500 steps, hidden 16, rbg keys): three
    generations card against CPU, bitwise; the marginal ms a generation
    (N and 2N, two pairs); one generation of the masked rollout; the
    device's share of a window of rollout steps under the profiler; the
    maximum fitness must rise over 5 generations (or, where it starts
    at its ceiling of 500, stay there while the average rises).  No
    kernel of the port is on this path: its launch counts must stay
    zero."""
    import torch
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    from deap_tpu_torch.examples.ga import evopole as EV
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    kernels.reset_launches()
    pop, log, hof = evopole_run(dev, EVO_REF_GENS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cpop, clog, chof = evopole_run(cpu, EVO_REF_GENS)
    cpu_s = time.perf_counter() - t
    names = sorted(pop.genome)
    same = {
        "genome": all(_same_bits(pop.genome[k], cpop.genome[k])
                      for k in names),
        "values": _same_bits(pop.fitness.values, cpop.fitness.values),
        "logbook": all(log.select(c) == clog.select(c)
                       for c in ("gen", "nevals", "max", "avg")),
        "archive": (all(_same_bits(hof.state.genome[k],
                                   chof.state.genome[k]) for k in names)
                    and _same_bits(hof.state.values, chof.state.values))}

    def run(ngen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        evopole_run(dev, ngen)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    per_gen, marginals, pairs = _timed_pairs(run, EVO_TIMING_NGEN, EVO_PAIRS)

    # one generation with the masked rollout, from the same state as the
    # fixed-length one: the same fitness, in fewer steps
    key, pop0, tb = evopole_setup(dev)
    pop0, _ = evaluate_population(tb, pop0)
    _, _, tbm = evopole_setup(dev, masked=True)

    def one_gen(toolbox):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = ea_step(key, pop0, toolbox, EV.CXPB, EV.MUTPB)[1]
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    ms_fixed, out_fixed = one_gen(tb)
    ms_masked, out_masked = one_gen(tbm)
    masked_same = _same_bits(out_fixed.fitness.values,
                             out_masked.fitness.values)

    # the rollout's body, as ``rollout_population`` runs it (deferred
    # rounding, the small-argument sine and cosine), under the profiler:
    # kernel launches a step and the device's busy share of the wall clock
    from deap_tpu_torch._xla_math import deferred_rounding, sincos_small
    state = torch.zeros((EV.POP, EV.N_EPISODES, 4), device=dev)
    g = {k: v.unsqueeze(1).double() if k[0] == "w" else v.unsqueeze(1)
         for k, v in pop0.genome.items()}

    def steps():
        s = state
        with deferred_rounding() as rounding:
            for _ in range(EVO_PROFILE_STEPS):
                s = EV._env_step(s, EV.policy_action(g, s), sincos_small)
                rounding.check()

    steps()
    prof = _profile_window(steps, EVO_PROFILE_STEPS)

    _, rlog, _ = evopole_run(dev, EVO_RISE_GENS)
    launches = dict(kernels.LAUNCHES)
    best, avg = rlog.select("max"), rlog.select("avg")
    phase("evopole ea_simple + HallOfFame(1) (BASELINE config 5), rbg",
          card_line, key_impl="rbg", pop=EV.POP, episodes=EV.N_EPISODES,
          max_steps=EV.MAX_STEPS, hidden=EV.HIDDEN,
          ref_gens=EVO_REF_GENS, card_equals_cpu=same,
          cpu_seconds_ref_gens=cpu_s,
          timing_ngen=[EVO_TIMING_NGEN, 2 * EVO_TIMING_NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          env_steps_per_s=EV.POP * EV.N_EPISODES * EV.MAX_STEPS / per_gen,
          masked_generation_ms=ms_masked * 1e3,
          fixed_generation_ms=ms_fixed * 1e3,
          masked_equals_fixed=masked_same,
          rollout_step_profile=prof,
          kernel_launches_per_gen_rollout=(
              prof["kernel_launches"] * EV.MAX_STEPS),
          max_by_gen=best, avg_by_gen=avg, port_kernel_launches=launches)
    if not all(same.values()):
        fail(f"evopole card vs CPU differ: {same}")
    if not masked_same:
        fail("evopole: the masked rollout's fitness differs")
    # from bench_evopole.py's key the initial population already holds a
    # policy that balances all four episodes: a maximum at its ceiling
    # cannot rise, and then the average must
    if not (best[-1] > best[0] or (best[0] == EV.MAX_STEPS
                                   and min(best) == EV.MAX_STEPS
                                   and avg[-1] > avg[0])):
        fail(f"evopole: the maximum fitness did not rise (max {best}, "
             f"avg {avg})")
    if any(launches.values()):
        fail(f"a port kernel ran on the evopole path: {launches}")
    return {"marginal_ms_per_gen": per_gen * 1e3}


# ---------------------------------------------------------------------------
# the rest of multi-objective: random.permutation, sel_tournament_dcd,
# bench_nsga2.py's BENCH_SELECT=nsga3 | spea2 and BENCH_STAGED=1, the
# NSGA-II and NSGA-III examples
# ---------------------------------------------------------------------------

# bench_nsga2.py's reference points ({2: 99, 3: 12} divisions) and SPEA2
# chunk (max(64, min(1024, 1e8 // (2 POP))): 500 at POP 1e5)
BN_P = {2: 99, 3: 12}
MO_REF_POP = 4096
# (N, pairs) of the (N, 2N) timing at POP 1e5, and the problems run there
MO_SEL_PATHS = {"nsga3": ((2, 3), ("zdt1", "dtlz2")),
                "spea2": ((1, 1), ("zdt1", "dtlz2")),
                "spea2-staged": ((1, 1), ("dtlz2",))}
TRUNC_N, TRUNC_K = 8192, 4096
PERM_SIZES = (1000, 1 << 20)


def bench_chunk(n: int) -> int:
    return max(64, min(1024, 10 ** 8 // (2 * n)))


def bench_select(name: str, nobj: int, n: int):
    """The environmental selection of bench_nsga2.py's ``BENCH_SELECT``
    (``nsga3``, ``spea2``) or of ``BENCH_STAGED=1`` (``spea2-staged``,
    the script's two stage calls), as ``select(k_sel, fitness, n)``."""
    from deap_tpu_torch.ops import emo
    chunk = bench_chunk(n)
    if name == "nsga3":
        rp = emo.uniform_reference_points(nobj, BN_P[nobj])
        return lambda k, f, m: emo.sel_nsga3(k, f, m, rp)
    if name == "spea2":
        return lambda k, f, m: emo.sel_spea2(k, f, m, chunk=chunk)
    return lambda k, f, m: emo.sel_spea2_staged(k, f, m, chunk=chunk)


def mo_quality(problem: str, fitness) -> float:
    """DTLZ2's mean ``|sum f^2 - 1|`` (must fall) or ZDT1's hypervolume
    at (11, 11) (must rise)."""
    from deap_tpu_torch.ops import hv as host_hv
    v = fitness.values
    if problem == "dtlz2":
        return float(((v.double() ** 2).sum(1) - 1.0).abs().mean().item())
    return host_hv.hypervolume(v.double().cpu().numpy(), HV_REF["zdt1"])


def permutation_phase(card_line) -> None:
    """``random.permutation`` at 2**20 (two rounds) and 1000 (one) under
    both key implementations: card equal to CPU bit for bit, and the
    card's ms (CUDA events)."""
    import torch
    from deap_tpu_torch import random
    dev = torch.device("cuda")
    same, ms = {}, {}
    for impl in ("threefry2x32", "rbg"):
        for n in PERM_SIZES:
            key = random.PRNGKey(n, impl=impl, device="cpu")
            kd = key.to(dev)
            tag = f"{impl} n={n}"
            same[tag] = torch.equal(random.permutation(kd, n).cpu(),
                                    random.permutation(key, n))
            ms[tag] = cuda_ms(lambda: random.permutation(kd, n), reps=5,
                              warm=1)
    phase("random.permutation card vs CPU", card_line, bitwise=same,
          ms=ms, rounds={n: random._shuffle_rounds(n) for n in PERM_SIZES})
    if not all(same.values()):
        fail(f"random.permutation on the card differs from the CPU: {same}")


def dcd_phase(card_line, key, pop) -> None:
    """``sel_tournament_dcd`` on a 1e5-point DTLZ2 population (NSGA-III's
    at full width): card equal to CPU bit for bit."""
    import torch
    from deap_tpu_torch.ops import emo
    n = pop.size
    kc = key.cpu()
    fc = pop.fitness
    fh = type(fc)(fc.values.cpu(), fc.valid.cpu(), fc.weights)
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = emo.sel_tournament_dcd(key, fc, n)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    b = emo.sel_tournament_dcd(kc, fh, n)
    cpu_s = time.perf_counter() - t
    same = torch.equal(a.cpu(), b)
    phase("sel_tournament_dcd card vs CPU, DTLZ2 population", card_line,
          pop=n, k=n, bitwise=same, card_seconds=card_s, cpu_seconds=cpu_s,
          distinct_winners=int(torch.unique(a).numel()))
    if not same:
        fail("sel_tournament_dcd on the card differs from the CPU")


def mo_select_reference(card_line, key, problem: str, name: str) -> None:
    """One published generation at POP 4096 with ``BENCH_SELECT`` (or
    the staged SPEA2), card against CPU: offspring, objective values
    and selected indices bitwise."""
    import torch
    from deap_tpu_torch import random
    dev = torch.device("cuda")
    nobj, _ = BN_PROBLEMS[problem]
    tb = bench_nsga2_toolbox(problem)
    k_init, k_gen = random.split(key.cpu())
    pop = bench_nsga2_initial(tb, k_init, problem, MO_REF_POP)
    select = bench_select(name, nobj, MO_REF_POP)
    outs = []
    for d in (torch.device("cpu"), dev):
        p = type(pop)(pop.genome.to(d), type(pop.fitness)(
            pop.fitness.values.to(d), pop.fitness.valid.to(d),
            pop.fitness.weights))
        t = time.perf_counter()
        _, new = bench_nsga2_generation(tb, k_gen.to(d), p, select=select)
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs.append((new, time.perf_counter() - t))
    (c, cpu_s), (g, card_s) = outs
    same = {"genome": torch.equal(c.genome.view(torch.int32),
                                  g.genome.cpu().view(torch.int32)),
            "values": torch.equal(c.fitness.values.view(torch.int32),
                                  g.fitness.values.cpu().view(torch.int32))}
    phase(f"reference: bench_nsga2 {name} {problem} generation card vs CPU",
          card_line, pop=MO_REF_POP, nobj=nobj, bitwise=same,
          cpu_seconds=cpu_s, card_seconds=card_s)
    if not all(same.values()):
        fail(f"bench_nsga2 {name} {problem} at POP {MO_REF_POP}: card and "
             f"CPU differ: {same}")


def mo_select_main_path(kernels, card_line, key, problem: str, name: str):
    """``bench_nsga2.py`` with ``BENCH_SELECT=name`` at POP 1e5 (depth
    cut): N and 2N generations in pairs (median marginal ms), launches
    counted on a 2N-generation run zeroed before it, the quality metric
    from generation 0 to the end.  Returns (launches, marginal ms, final
    population)."""
    import torch
    from deap_tpu_torch import random
    nobj, ndim = BN_PROBLEMS[problem]
    tb = bench_nsga2_toolbox(problem)
    k_init, k_run = random.split(key)
    pop0 = bench_nsga2_initial(tb, k_init, problem, BN_POP)
    select = bench_select(name, nobj, BN_POP)
    ngen, pairs_n = MO_SEL_PATHS[name][0]
    q0 = mo_quality(problem, pop0.fitness)
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(n):
            k, pop = bench_nsga2_generation(tb, k, pop, select=select)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    run(1)                                     # warm the allocator
    kernels.reset_launches()
    t2n = run(2 * ngen)
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(run, ngen, pairs_n)
    pop = state[2 * ngen]
    q1 = mo_quality(problem, pop.fitness)
    ok = (tuple(pop.genome.shape) == (BN_POP, ndim)
          and bool(torch.isfinite(pop.fitness.values).all())
          and bool(pop.fitness.valid.all())
          and bool(((pop.genome >= 0) & (pop.genome <= 1)).all()))
    metric = "front_error" if problem == "dtlz2" else "hypervolume_11_11"
    phase(f"main path: bench_nsga2 {name} {problem}", card_line, pop=BN_POP,
          dim=ndim, nobj=nobj, chunk=bench_chunk(BN_POP),
          divisions=BN_P[nobj] if name == "nsga3" else None,
          ngen=[ngen, 2 * ngen], seconds=[list(p) for p in pairs],
          counted_run_seconds=t2n, marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          linearity=[b / a for a, b in pairs], launches=launches,
          launches_per_gen={k: v / (2 * ngen) for k, v in launches.items()},
          **{f"{metric}_start": q0, f"{metric}_end": q1},
          finite_valid_in_bounds=ok)
    if not ok:
        fail(f"bench_nsga2 {name} {problem}: the population is not finite, "
             "valid, in bounds and shaped")
    better = q1 < q0 if problem == "dtlz2" else q1 > q0
    if not better:
        fail(f"bench_nsga2 {name} {problem}: {metric} {q0} -> {q1}")
    uses_k4 = name.startswith("spea2") or nobj >= 3
    if uses_k4 and launches["rows_dominate_counts"] < 1:
        fail(f"K4 never ran on bench_nsga2 {name} {problem}")
    return launches, per_gen * 1e3, pop


def spea2_checks_phase(card_line, key) -> dict:
    """SPEA2 beyond the generation: the single program against the two
    stage calls on the card (POP 4096 pool, both problems), and the
    truncation branch card against CPU: 8192 DTLZ2 points on the true
    front (distance genes 0.5), k = 4096."""
    import torch
    from deap_tpu_torch import base, random
    from deap_tpu_torch.ops import emo
    dev = torch.device("cuda")
    k_pool, k_trunc = random.split(key)
    staged_same = {}
    for problem in BN_PROBLEMS:
        nobj, ndim = BN_PROBLEMS[problem]
        tb = bench_nsga2_toolbox(problem)
        pool = bench_nsga2_initial(tb, random.fold_in(k_pool, nobj), problem,
                                   2 * MO_REF_POP)
        chunk = bench_chunk(MO_REF_POP)
        a = emo.sel_spea2(None, pool.fitness, MO_REF_POP, chunk=chunk)
        b = emo.sel_spea2_staged(None, pool.fitness, MO_REF_POP, chunk=chunk)
        staged_same[problem] = torch.equal(a, b)
    g = random.uniform(k_trunc, (TRUNC_N, 12))
    g[:, 2:] = 0.5
    fit = base.Fitness.empty(TRUNC_N, (-1.0,) * 3, device=dev).with_values(
        dtlz2_values(g))
    fh = base.Fitness(fit.values.cpu(), fit.valid.cpu(), fit.weights)
    n_nondom = int((emo.nondominated_ranks(fit.masked_wvalues())[0] == 0)
                   .sum().item())
    torch.cuda.synchronize()
    t = time.perf_counter()
    a = emo.sel_spea2(None, fit, TRUNC_K, chunk=500)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    b = emo.sel_spea2(None, fh, TRUNC_K, chunk=500)
    cpu_s = time.perf_counter() - t
    trunc_same = torch.equal(a.cpu(), b)
    phase("SPEA2: staged = single on the card; truncation card vs CPU",
          card_line, staged_equals_single=staged_same, pool=2 * MO_REF_POP,
          trunc_points=TRUNC_N, trunc_k=TRUNC_K, nondominated=n_nondom,
          trunc_bitwise=trunc_same, trunc_card_seconds=card_s,
          trunc_cpu_seconds=cpu_s)
    if not all(staged_same.values()):
        fail(f"SPEA2: the staged calls differ from sel_spea2: {staged_same}")
    if n_nondom <= TRUNC_K:
        fail(f"SPEA2 truncation case: only {n_nondom} nondominated points")
    if not trunc_same:
        fail("SPEA2 truncation: card and CPU differ")
    return {"truncation_card_seconds": card_s}


def examples_phase(kernels, card_line) -> dict:
    """``examples/ga/nsga2.py`` (ZDT1, mu 64, 100 generations) and
    ``examples/ga/nsga3.py`` (DTLZ2, 92, 100) at their defaults on the
    card and on the CPU: populations bitwise, the NSGA-II hypervolume at
    (11, 11) > 116, NSGA-III's front error reported."""
    import torch
    from deap_tpu_torch.examples.ga import nsga2, nsga3
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out, launches = {}, {}
    for name, mod in (("nsga2", nsga2), ("nsga3", nsga3)):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pg, qg = mod.main(seed=1, verbose=False, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches[name] = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        pc, qc = mod.main(seed=1, verbose=False, device=cpu)
        cpu_s = time.perf_counter() - t
        same = (torch.equal(pg.genome.cpu().view(torch.int32),
                            pc.genome.view(torch.int32))
                and torch.equal(pg.fitness.values.cpu().view(torch.int32),
                                pc.fitness.values.view(torch.int32)))
        out[name] = dict(bitwise=same, card_seconds=card_s,
                         cpu_seconds=cpu_s, card=qg, cpu=qc,
                         launches=launches[name])
    phase("examples: nsga2.py and nsga3.py at their defaults", card_line,
          nsga2_hypervolume=out["nsga2"]["card"],
          nsga3_front_error=out["nsga3"]["card"], runs=out)
    for name, r in out.items():
        if not r["bitwise"]:
            fail(f"examples/ga/{name}.py: card and CPU populations differ")
    if not out["nsga2"]["card"] > 116.0:
        fail(f"examples/ga/nsga2.py: hypervolume {out['nsga2']['card']} "
             "<= 116")
    return launches


# ---------------------------------------------------------------------------
# the rest of GP: the remaining tree operators, static_limit, HARM-GP, the
# lexicase and double-tournament selections, and the eight GP examples
# (ADFs, routines) — K6 evaluates every bench-width generation
# ---------------------------------------------------------------------------

# the operators of phase 34, in order: (name, mutation or crossover, the
# pset it needs)
GP_NEW_OPS = (("mut_node_replacement", "bench"), ("mut_ephemeral one",
                                                  "bench"),
              ("mut_ephemeral all", "bench"), ("mut_insert", "bench"),
              ("mut_shrink", "bench"), ("mut_semantic", "semantic"),
              ("cx_semantic", "semantic"),
              ("static_limit(cx_one_point)", "bench"),
              ("static_limit(mut_uniform)", "bench"))
GP_OPS_WARM_GENS = 3               # bench generations before the operators
# symbreg_harm.py's HARM parameters
HARM_KW = dict(alpha=0.05, beta=10.0, gamma=0.25, rho=0.9, mincutoff=10)
HARM_REF_POP, HARM_REF_GENS = 512, 2
HARM_NGEN, HARM_PAIRS = 2, 3
# the bench generation with each new mutation and with static_limit
GP_VARIANT_NGEN, GP_VARIANT_PAIRS = 2, 3
LEX_REF_N, LEX_REF_CASES = 512, 128
LEX_EPS = 0.1
LEX_REPS = 3
# the examples: default generations on the card; on the CPU at the
# defaults where that takes seconds, else at tests/test_examples.py's depth
GP_EXAMPLES = ("symbreg", "symbreg_epsilon_lexicase", "symbreg_harm",
               "adf_symbreg", "multiplexer", "parity", "spambase", "ant")
GP_EXAMPLE_CPU_DEPTH = {"ant": 3}
GP_EXAMPLE_CHECKS = {"multiplexer": 56, "parity": 8, "spambase": 0.6,
                     "ant": 20}


def _same_tensors(a, b) -> bool:
    import torch
    ta, tb = (x if isinstance(x, (tuple, list)) else (x,) for x in (a, b))
    out = True
    for x, y in zip(ta, tb):
        if isinstance(x, (tuple, list)):
            out = out and _same_tensors(x, y)
            continue
        x, y = x.cpu(), y.cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out = out and torch.equal(x, y)
    return out


def gp_operator(name, ps, gen_mut):
    """``(op(keys, *trees), arity)`` for a phase-34 operator name."""
    from deap_tpu_torch import gp
    from deap_tpu_torch.probes.gp import HEIGHT_LIMIT
    frozen = ps.freeze()

    def height(t):
        return gp.tree_height(t[0], t[2], frozen.tables(t[0].device)["arity"])
    expr = lambda kk: gen_mut(kk, 0, 2)                     # noqa: E731
    ops = {
        "mut_node_replacement": (lambda k, t: gp.mut_node_replacement(
            k, t, ps), 1),
        "mut_ephemeral one": (lambda k, t: gp.mut_ephemeral(
            k, t, ps, mode="one"), 1),
        "mut_ephemeral all": (lambda k, t: gp.mut_ephemeral(
            k, t, ps, mode="all"), 1),
        "mut_insert": (lambda k, t: gp.mut_insert(k, t, ps), 1),
        "mut_shrink": (lambda k, t: gp.mut_shrink(k, t, ps), 1),
        "mut_semantic": (lambda k, t: gp.mut_semantic(k, t, ps), 1),
        "cx_semantic": (lambda k, a, b: gp.cx_semantic(k, a, b, ps), 2),
        "static_limit(cx_one_point)": (lambda k, a, b: gp.static_limit(
            height, HEIGHT_LIMIT)(gp.cx_one_point)(k, a, b, ps), 2),
        "static_limit(mut_uniform)": (lambda k, t: gp.static_limit(
            height, HEIGHT_LIMIT)(gp.mut_uniform)(k, t, expr, ps), 1)}
    return ops[name]


def gp_operators_phase(kernels, card_line, key, dev) -> dict:
    """Phase 34: each new operator and ``static_limit`` (height <= 17)
    on a POP 4096 x CAP 64 population a few bench generations old (the
    semantic ones on the bench set with ``lf``): the card's children
    against the CPU's from the same keys, bitwise; then K6 on the
    children against the plain interpreter, bitwise (``k6_check``)."""
    import torch
    from deap_tpu_torch import random
    cpu = torch.device("cpu")
    out, k6 = {}, {}
    pops = {}
    for kind in ("bench", "semantic"):
        ps, tb, _, gen_init, X = gp_toolbox(dev, kind)
        k_init, k_run = random.split(random.fold_in(key, len(pops)))
        pop = gp_initial(tb, gen_init, k_init, GP_POP)
        for _ in range(GP_OPS_WARM_GENS):
            k_run, pop, _ = gp_generation(tb, k_run, pop)
        pops[kind] = (ps, pop.genome, X)
    for i, (name, kind) in enumerate(GP_NEW_OPS):
        ps, genome, X = pops[kind]
        from deap_tpu_torch import gp
        gen_mut = gp.make_generator(ps, GP_CAP, "full")
        op, arity = gp_operator(name, ps, gen_mut)
        k_op = random.fold_in(key, 100 + i)
        n = GP_POP // arity
        keys = random.split(k_op, n)
        if arity == 1:
            args = (genome,)
        else:
            args = (tuple(g[:n] for g in genome),
                    tuple(g[n:2 * n] for g in genome))
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = op(keys, *args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        host = op(keys.to(cpu), *(tuple(g.to(cpu) for g in a) for a in args))
        cpu_s = time.perf_counter() - t
        same = _same_tensors(card, host)
        kids = card if arity == 1 else tuple(torch.cat([a, b])
                                             for a, b in zip(*card))
        parents = genome if arity == 1 else tuple(
            torch.cat([a, b]) for a, b in zip(*args))
        changed = ((kids[2] != parents[2]) | (kids[0] != parents[0]).any(1)
                   | (kids[1] != parents[1]).any(1))
        full = kids[2] == GP_CAP
        lf = ps.freeze().names.index("lf") if kind == "semantic" else -1
        out[name] = dict(card_cpu_bitwise=same, card_s=card_s, cpu_s=cpu_s,
                         rows_changed=int(changed.sum()),
                         rows_at_capacity=int(full.sum()),
                         mean_length=float(kids[2].float().mean()),
                         rows_with_lf=int((kids[0] == lf).any(1).sum())
                         if lf >= 0 else None)
        if not same:
            fail(f"{name} on the card differs from the CPU at {GP_POP} x "
                 f"{GP_CAP}")
        k6[name] = k6_check(kernels, card_line, f"children of {name}",
                            ps.freeze(), kids, X)
    phase("GP operators card vs CPU at bench width, K6 on the children",
          card_line, pop=GP_POP, cap=GP_CAP, warm_generations=GP_OPS_WARM_GENS,
          operators=out)
    return k6


def harm_reference_chain(key):
    """The CPU's side of phase 35: the initial POP 512 population from
    ``key``, then ``HARM_REF_GENS`` generations each from the one before."""
    import torch
    from deap_tpu_torch import gp, random
    _, tb, _, gen, _ = gp_toolbox(torch.device("cpu"))
    chain = [gp_initial(tb, gen, key, HARM_REF_POP)]
    k = random.fold_in(key, 1)
    for _ in range(HARM_REF_GENS):
        chain.append(gp.harm(k, chain[-1], tb, GP_CXPB, GP_MUTPB, 1,
                             **HARM_KW)[0])
        k = random.split(k, 4)[0]
    return chain


def harm_phase(kernels, card_line, key, dev) -> tuple:
    """Phase 35: HARM-GP.  Two generations at POP 512 (2000 natural
    children) on the bench toolbox, each from the CPU's population and
    key before it, card against CPU: trees bitwise, fitness within
    ``GP_FITNESS_RTOL`` (the MSE's mean reduces in another order on the
    card).  Then POP 4096 with symbreg_harm.py's parameters: N and 2N
    generations in pairs (median marginal ms), K6 counted, the mean size
    and best MSE."""
    import torch
    from deap_tpu_torch import base, gp, random
    k_ref, k_init, k_run = random.split(key, 3)
    _, tb_d, ev_d, _, _ = gp_toolbox(dev)
    t = time.perf_counter()
    chain = harm_reference_chain(k_ref.cpu())
    cpu_s = time.perf_counter() - t
    k = random.fold_in(k_ref, 1)
    ref = []
    for pop_h, pop_h1 in zip(chain, chain[1:]):
        pop_d = base.Population(tuple(g.to(dev) for g in pop_h.genome),
                                base.Fitness(pop_h.fitness.values.to(dev),
                                             pop_h.fitness.valid.to(dev),
                                             (-1.0,)))
        out_d, _ = gp.harm(k, pop_d, tb_d, GP_CXPB, GP_MUTPB, 1, **HARM_KW)
        trees = _same_tensors(out_d.genome, pop_h1.genome)
        v1, fd = pop_h1.fitness.values, out_d.fitness.values.cpu()
        rel = float(((v1 - fd).abs() / v1.abs().clamp(min=1e-30)).max())
        ref.append(dict(trees_bitwise=trees, fitness_max_rel_err=rel))
        if not (trees and rel <= GP_FITNESS_RTOL):
            fail(f"HARM generation on the card differs from the CPU: trees "
                 f"{trees}, fitness rel err {rel}")
        k = random.split(k, 4)[0]
    # full width
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev)
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP)
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = gp.harm(k_run, pop0, tb, GP_CXPB, GP_MUTPB, n, **HARM_KW)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    run(1)
    kernels.reset_launches()
    t2n = run(2 * HARM_NGEN)
    launches = dict(kernels.LAUNCHES)
    per_gen, marginals, pairs = _timed_pairs(run, HARM_NGEN, HARM_PAIRS)
    pop = state[2 * HARM_NGEN]
    size0 = float(pop0.genome[2].float().mean())
    size1 = float(pop.genome[2].float().mean())
    best0 = float(pop0.fitness.values.min())
    best1 = float(pop.fitness.values.min())
    ok = bool(pop.fitness.valid.all()) and bool(
        torch.isfinite(pop.fitness.values).all())
    phase("HARM-GP at bench width (symbreg_harm.py's parameters)", card_line,
          reference=dict(pop=HARM_REF_POP, natural=max(2000, HARM_REF_POP),
                         generations=ref, fitness_rtol=GP_FITNESS_RTOL,
                         cpu_chain_s=cpu_s),
          pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          natural=max(2000, GP_POP), ngen=[HARM_NGEN, 2 * HARM_NGEN],
          seconds=[list(p) for p in pairs], counted_run_seconds=t2n,
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          launches=launches, mean_size_start=size0, mean_size_end=size1,
          best_mse_start=best0, best_mse_end=best1, valid_finite=ok,
          evaluator_backend=pop_ev.last_backend)
    if launches["gp_interp"] != 2 * HARM_NGEN + 1:
        fail(f"K6 ran {launches['gp_interp']} times in {2 * HARM_NGEN} HARM "
             f"generations (expected {2 * HARM_NGEN + 1})")
    if not ok:
        fail("HARM left an invalid or non-finite population")
    return launches, pop, tb


def profile_harm(key, pop, tb, card_line) -> None:
    """``--profile`` for HARM: each stage of a generation alone."""
    import torch
    from deap_tpu_torch import gp, random
    from deap_tpu_torch.algorithms import evaluate_population, var_or
    from deap_tpu_torch.gp.harm import _KDE, acceptance, size_histogram
    n, m = pop.size, max(2000, pop.size)
    k_sel, k_nat, k_acc = random.split(key, 4)[1:]
    idx = tb.select(k_sel, pop.fitness, m)
    parents = pop.take(idx)
    natural = var_or(k_nat, parents, tb, m, GP_CXPB, GP_MUTPB)

    def accept():
        return acceptance(k_acc, natural.genome[2],
                          natural.fitness.masked_wvalues(), n,
                          HARM_KW["alpha"], HARM_KW["beta"],
                          HARM_KW["gamma"], HARM_KW["rho"],
                          HARM_KW["mincutoff"], GP_CAP + 3)[0]
    chosen = accept()
    nbins = GP_CAP + 3
    sizes = natural.genome[2].to(torch.int64)

    def hist_on_card():
        # the same hits by index_add_ on the card: its float32 adds run in
        # no fixed order, so its last bits are not XLA's (timed, not used)
        hist = torch.zeros(nbins, device=sizes.device)
        for off, w in _KDE:
            b = sizes + off
            ok = (b >= 0) & (b < nbins)
            hist.index_add_(0, torch.where(ok, b, nbins - 1),
                            torch.where(ok, w, 0.0))
        return hist
    stages = {
        "select m parents (sel_tournament)": lambda: tb.select(
            k_sel, pop.fitness, m),
        "var_or m natural children": lambda: var_or(
            k_nat, parents, tb, m, GP_CXPB, GP_MUTPB),
        "acceptance (histogram on the host, cutoff, target)": accept,
        "size histogram on the host (read + numpy.add.at)":
            lambda: size_histogram(sizes, nbins),
        "size histogram by index_add_ on the card (unordered)": hist_on_card,
        "evaluate n offspring (K6)": lambda: evaluate_population(
            tb, natural.take(chosen)),
        "whole generation": lambda: gp.harm(key, pop, tb, GP_CXPB,
                                            GP_MUTPB, 1, **HARM_KW)}
    phase("profile: HARM stage wall ms (synchronized, alone)", card_line,
          stages={k: _wall_ms(f, reps=3) for k, f in stages.items()})


def gp_variants_phase(kernels, card_line, key, dev) -> dict:
    """Phase 36: bench_gp.py's generation with each new mutation in place
    of ``mut_uniform`` (``mut_semantic`` on the set with ``lf``) and with
    ``static_limit`` on both operators: N and 2N generations in pairs,
    K6 once a generation."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.probes.gp import HEIGHT_LIMIT, MUTATIONS
    variants = [(m, dict(mutate=m)) for m in MUTATIONS[1:]]
    variants.append(("static_limit both", dict(limit=HEIGHT_LIMIT)))
    out, launches_all = {}, {}
    for i, (name, kw) in enumerate(variants):
        kind = "semantic" if name == "semantic" else "bench"
        ps, tb, pop_ev, gen_init, X = gp_toolbox(dev, kind, **kw)
        k_init, k_run = random.split(random.fold_in(key, i))
        pop0 = gp_initial(tb, gen_init, k_init, GP_POP)
        state = {}

        def run(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            k, pop = k_run, pop0
            for _ in range(n):
                k, pop, _ = gp_generation(tb, k, pop)
            torch.cuda.synchronize()
            state[n] = pop
            return time.perf_counter() - t

        run(1)
        kernels.reset_launches()
        run(2 * GP_VARIANT_NGEN)
        launches = dict(kernels.LAUNCHES)
        per_gen, marginals, pairs = _timed_pairs(run, GP_VARIANT_NGEN,
                                                 GP_VARIANT_PAIRS)
        pop = state[2 * GP_VARIANT_NGEN]
        out[name] = dict(marginal_ms_per_gen=per_gen * 1e3,
                         marginal_ms_range=[marginals[0] * 1e3,
                                            marginals[-1] * 1e3],
                         launches=launches,
                         mean_length_start=float(pop0.genome[2].float()
                                                 .mean()),
                         mean_length_end=float(pop.genome[2].float().mean()),
                         best_mse_start=float(pop0.fitness.values.min()),
                         best_mse_end=float(pop.fitness.values.min()))
        launches_all[name] = launches["gp_interp"]
        if launches["gp_interp"] != 2 * GP_VARIANT_NGEN:
            fail(f"K6 ran {launches['gp_interp']} times in "
                 f"{2 * GP_VARIANT_NGEN} bench generations with {name}")
        if not bool(torch.isfinite(pop.fitness.values).all()):
            fail(f"bench generation with {name}: non-finite fitness")
    phase("GP bench generation with each new mutation and static_limit",
          card_line, pop=GP_POP, cap=GP_CAP, points=GP_NPOINTS,
          ngen=[GP_VARIANT_NGEN, 2 * GP_VARIANT_NGEN],
          pairs=GP_VARIANT_PAIRS, height_limit=HEIGHT_LIMIT, variants=out)
    return launches_all


def lexicase_phase(kernels, card_line, key, dev) -> tuple:
    """Phase 37: the lexicase forms and ``sel_double_tournament`` card
    against CPU on 512 trees' absolute errors at 128 points (bitwise
    indices); then ``sel_automatic_epsilon_lexicase`` alone on the card
    over the bench population's 4096 x 1024 case errors, and bench
    generations that select with it (K6 counted)."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import selection as S
    cpu = torch.device("cpu")
    k_ref, k_sel, k_init, k_run = random.split(key, 4)
    k_ref = k_ref.cpu()
    from deap_tpu_torch.probes.gp import bench_toolbox
    _, tb_r, _, gen_r, _ = bench_toolbox(cpu, "bench", False, GP_CAP,
                                         LEX_REF_CASES, select="lexicase")
    pop_r = gp_initial(tb_r, gen_r, k_ref, LEX_REF_N, LEX_REF_CASES)
    cases = pop_r.fitness.masked_wvalues()
    sizes = pop_r.genome[2]
    mse = pop_r.fitness.values.mean(dim=1, keepdim=True)
    forms = {
        "sel_lexicase": lambda k, c, d: S.sel_lexicase(k, c, LEX_REF_N),
        "sel_epsilon_lexicase": lambda k, c, d: S.sel_epsilon_lexicase(
            k, c, LEX_REF_N, LEX_EPS),
        "sel_automatic_epsilon_lexicase":
            lambda k, c, d: S.sel_automatic_epsilon_lexicase(k, c, LEX_REF_N),
        "sel_double_tournament fitness_first":
            lambda k, c, d: S.sel_double_tournament(
                k, -mse.to(d), sizes.to(d), LEX_REF_N, 3, 1.4, True),
        "sel_double_tournament size_first":
            lambda k, c, d: S.sel_double_tournament(
                k, -mse.to(d), sizes.to(d), LEX_REF_N, 3, 1.4, False)}
    ref = {}
    for name, f in forms.items():
        a = f(k_sel, cases.to(dev), dev)
        b = f(k_sel.cpu(), cases, cpu)
        ref[name] = dict(bitwise=bool(torch.equal(a.cpu(), b)),
                         distinct=int(torch.unique(b).numel()))
        if not ref[name]["bitwise"]:
            fail(f"{name} on the card differs from the CPU")
    # full width: 4096 x 1024 case errors of a bench population
    ps, tb, pop_ev, gen_init, X = gp_toolbox(dev, "bench",
                                                  select="lexicase")
    pop0 = gp_initial(tb, gen_init, k_init, GP_POP, GP_NPOINTS)
    cases = pop0.fitness.masked_wvalues()
    secs = []
    for _ in range(LEX_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = S.sel_automatic_epsilon_lexicase(k_sel, cases, GP_POP)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    secs.sort()
    state = {}

    def run(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        k, pop = k_run, pop0
        for _ in range(n):
            k, pop, _ = gp_generation(tb, k, pop)
        torch.cuda.synchronize()
        state[n] = pop
        return time.perf_counter() - t

    kernels.reset_launches()
    t1 = run(1)
    launches = dict(kernels.LAUNCHES)
    t2 = run(2)
    pop = state[2]
    phase("lexicase and double tournament: card vs CPU, full width",
          card_line, reference=dict(rows=LEX_REF_N, cases=LEX_REF_CASES,
                                    epsilon=LEX_EPS, forms=ref),
          pop=GP_POP, cases=GP_NPOINTS,
          automatic_epsilon_lexicase_s=secs[len(secs) // 2],
          automatic_epsilon_lexicase_s_all=secs,
          distinct_selected=int(torch.unique(idx).numel()),
          generation_s=[t1, t2], marginal_ms_per_gen=(t2 - t1) * 1e3,
          launches=launches,
          mean_abs_err_start=float(pop0.fitness.values.mean()),
          mean_abs_err_end=float(pop.fitness.values.mean()))
    if launches["gp_interp"] != 1:
        fail(f"K6 ran {launches['gp_interp']} times in one lexicase bench "
             "generation")
    return launches, cases, k_sel


def profile_lexicase(key, cases, card_line) -> None:
    """``--profile`` for lexicase: one case step's stages at full width
    (the gather of the case column, the best, the MAD epsilon's two
    medians, the mask update) and the whole selection under
    ``torch.profiler``."""
    import torch
    from deap_tpu_torch import random
    from deap_tpu_torch.ops import selection as S
    k, n = cases.shape[0], cases.shape[0]
    order = random.permutation(random.split(key, k), cases.shape[1]).long()
    by_case = cases.t().contiguous()
    mask = torch.rand(k, n, device=cases.device) < 0.5
    col = by_case[order[:, 0]]
    stages = {
        "permutation of the cases (k keys)": lambda: random.permutation(
            random.split(key, k), cases.shape[1]),
        "case column gather (k, n)": lambda: by_case[order[:, 0]],
        "best of the candidates": lambda: torch.where(
            mask, col, float("-inf")).amax(dim=1),
        "MAD epsilon (two nanmedians)": lambda: S._mad_eps(col, mask),
        "whole selection": lambda: S.sel_automatic_epsilon_lexicase(
            key, cases, k)}
    phase("profile: lexicase stage wall ms (synchronized, alone)", card_line,
          stages={name: _wall_ms(f, reps=3) for name, f in stages.items()})
    phase("profile: automatic epsilon-lexicase, one selection", card_line,
          **_profile_window(lambda: S.sel_automatic_epsilon_lexicase(
              key, cases, k), 1))


def gp_example_run(mod, dev, ngen=None):
    """``(population, quality)`` of one example's run on ``dev``: the
    final population and the best value the example reports (for the
    four that report one, from their ``run``)."""
    kw = {} if ngen is None else {"ngen": ngen}
    if hasattr(mod, "run"):
        return mod.run(device=dev, **kw)
    pop = mod.main(verbose=False, device=dev, **kw)
    v = pop.fitness.values
    return pop, float(v.sum(dim=1).min() if v.shape[1] > 1 else v.min())


def gp_examples_phase(kernels, card_line) -> dict:
    """Phase 38: the eight GP examples at their defaults on the card, each
    against its check (tests/test_examples.py), and card = CPU bitwise on
    the final population, trees and every individual's fitness: at the
    defaults, or at the tests' depth where the CPU would take minutes
    (the ant, whose fitness is each routine's food eaten)."""
    import importlib
    import torch
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out, launches = {}, {}
    for name in GP_EXAMPLES:
        mod = importlib.import_module(f"deap_tpu_torch.examples.gp.{name}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        card, quality = gp_example_run(mod, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches[name] = dict(kernels.LAUNCHES)
        depth = GP_EXAMPLE_CPU_DEPTH.get(name)
        card_at = card if depth is None else gp_example_run(mod, dev,
                                                            depth)[0]
        t = time.perf_counter()
        host = gp_example_run(mod, cpu, depth)[0]
        cpu_s = time.perf_counter() - t
        same = (_same_tensors(card_at.genome, host.genome)
                and _same_tensors(card_at.fitness.values,
                                  host.fitness.values))
        ok = bool(card.fitness.valid.all()) and bool(
            torch.isfinite(card.fitness.values).all())
        if name in GP_EXAMPLE_CHECKS:
            ok = ok and quality >= GP_EXAMPLE_CHECKS[name]
        extra = {}
        if name == "symbreg_harm":
            size = float(card.genome[2].float().mean())
            extra = {"mean_size": size}
            ok = ok and size < mod.CAP * 0.8
        out[name] = dict(card_cpu_bitwise=same, cpu_generations=depth or
                         "default", rows_compared=host.size,
                         card_seconds=card_s, cpu_seconds=cpu_s,
                         quality=quality, check=ok, **extra)
        if not same:
            fail(f"examples/gp/{name}.py: card and CPU differ")
        if not ok:
            fail(f"examples/gp/{name}.py: {quality} fails its check")
    phase("GP examples at their defaults", card_line, runs=out,
          cpu_threads=torch.get_num_threads())
    return launches


def gp_rest_phases(kernels, card_line, key, dev) -> dict:
    """Phases 34-38; returns K6's launches and times on their paths."""
    import torch
    from deap_tpu_torch import random
    torch.cuda.empty_cache()
    k_ops, k_harm, k_var, k_lex = random.split(random.fold_in(key, 8), 4)
    out = {"k6_children": gp_operators_phase(kernels, card_line, k_ops, dev)}
    launches_harm, harm_pop, harm_tb = harm_phase(kernels, card_line,
                                                  k_harm, dev)
    if "--profile" in sys.argv[1:]:
        profile_harm(k_harm, harm_pop, harm_tb, card_line)
    del harm_pop
    out["harm"] = launches_harm["gp_interp"]
    out["variants"] = gp_variants_phase(kernels, card_line, k_var, dev)
    launches_lex, lex_cases, k_lsel = lexicase_phase(kernels, card_line,
                                                     k_lex, dev)
    if "--profile" in sys.argv[1:]:
        profile_lexicase(k_lsel, lex_cases, card_line)
    del lex_cases
    out["lexicase"] = launches_lex["gp_interp"]
    out["examples"] = gp_examples_phase(kernels, card_line)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py needs a card")
    from deap_tpu_torch.probes import card_line as read_card_line
    try:
        card_line = read_card_line()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    kind = torch.cuda.get_device_name(0)
    print(f"# python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} on {card_line}", flush=True)

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    from deap_tpu_torch import kernels
    from deap_tpu_torch.kernels.build import build
    lib = build()
    kernels.load()
    phase("build", card_line, seconds=time.perf_counter() - t0,
          library=os.path.relpath(lib, ROOT))

    from deap_tpu_torch import base, benchmarks, random
    from deap_tpu_torch.algorithms import ea_simple, ea_step
    from deap_tpu_torch.ops import crossover, mutation, selection
    from deap_tpu_torch.ops import generation as G
    from deap_tpu_torch.utils.support import Statistics

    dev = torch.device("cuda")
    key = random.PRNGKey(0, device=dev)
    k_init, k_sel, k_var, k_run = random.split(key, 4)
    genome = random.uniform(k_init, (POP, DIM), minval=-5.12, maxval=5.12)
    values = torch.func.vmap(lambda g: benchmarks.rastrigin(g)[0])(genome)
    order = base.lex_sort_indices(-values[:, None]).to(torch.int32)
    pos = selection.tournament_positions(k_sel, POP, POP, 3)
    widx = order[pos.long()]
    seed = G._seed_from_key(k_var)
    knobs = torch.tensor([CXPB, MUTPB, MU, SIGMA, INDPB], device=dev)
    counts = tile_counts(seed, knobs, POP, DIM)
    phase("tile work of this run's draws", card_line, **counts)
    report = {}

    # ---- 2./3. K1 and K2 against their plain versions ---------------------
    storages = [G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
                G.GenomeStorage("int8", 5.12)]
    for st in storages:
        gs = st.to_storage(genome)
        elt = gs.element_size()
        parents = gs[widx.long()].contiguous()
        gap1, err1, ms1, plain1, dev1 = vary_check(kernels, G, parents,
                                                   seed, knobs, DIM, st)
        ops = tile_ops(counts, POP, DIM, st.dtype)
        b1, by1 = bound_ms(2 * POP * DIM * elt + 4 + 20, *ops)
        phase("K1 megakernel_vary vs plain", card_line, storage=st.dtype,
              ulp_gap=gap1, ulp_bound=ULP_BOUND, max_abs_err=err1,
              ms=ms1, device_ms=dev1, plain_ms=plain1, bound_ms=b1,
              bound_by=by1, shape=[POP, DIM])
        if gap1 > ULP_BOUND:
            fail(f"K1 {st.dtype}: {gap1} ulp from its plain version "
                 f"(bound {ULP_BOUND})")

        k2, w2 = kernels.launch_gather_vary(order, pos, gs, seed, knobs,
                                            dim=DIM, dtype=st.dtype,
                                            scale=st.scale)
        p2, pw = G._gather_vary_plain(order, pos, gs, seed, knobs, DIM, st)
        torch.cuda.synchronize()
        gap2 = ulp_gap(k2, p2)
        err2 = float((k2.float() - p2.float()).abs().max().item())
        if not torch.equal(w2, pw):
            fail(f"K2 {st.dtype}: winner indices differ from order[pos]")
        ms2 = cuda_ms(lambda: kernels.launch_gather_vary(
            order, pos, gs, seed, knobs, dim=DIM, dtype=st.dtype,
            scale=st.scale))
        plain2 = cuda_ms(lambda: G._gather_vary_plain(
            order, pos, gs, seed, knobs, DIM, st), reps=3, warm=1)
        b2, by2 = bound_ms(2 * POP * DIM * elt + 3 * 4 * POP + 4 + 20,
                           *ops)
        phase("K2 megakernel_gather_vary vs index_select+plain", card_line,
              storage=st.dtype, ulp_gap=gap2, ulp_bound=ULP_BOUND,
              max_abs_err=err2, widx_equal=True, ms=ms2, plain_ms=plain2,
              bound_ms=b2, bound_by=by2, shape=[POP, DIM])
        if gap2 > ULP_BOUND:
            fail(f"K2 {st.dtype}: {gap2} ulp from its plain version "
                 f"(bound {ULP_BOUND})")
        report[st.dtype] = {"K1": (err1, ms1, plain1, b1, by1, dev1),
                            "K2": (err2, ms2, plain2, b2, by2)}
        del gs, parents, k2, p2
        torch.cuda.empty_cache()

    # ---- 4. a whole generation on a small input, card against CPU --------
    n_small = 1024
    g_small = genome[:n_small]
    w_small = -values[:n_small, None]
    for gather in ("dma", "host"):
        outs = []
        for d in (dev, torch.device("cpu")):
            out, idx = G.fused_generation(
                k_sel.to(d), k_var.to(d), g_small.to(d), w_small.to(d),
                dim=DIM, cxpb=CXPB, mutpb=MUTPB, mut_mu=MU,
                mut_sigma=SIGMA, indpb=INDPB, gather=gather)
            outs.append((out.cpu(), idx.cpu()))
        same = (torch.equal(outs[0][0].view(torch.int32),
                            outs[1][0].view(torch.int32))
                and torch.equal(outs[0][1].to(torch.int64),
                                outs[1][1].to(torch.int64)))
        phase("reference: fused_generation card vs CPU", card_line,
              gather=gather, pop=n_small, dim=DIM, bitwise_equal=same)
        if not same:
            fail(f"fused_generation(gather={gather!r}) on the card differs "
                 "from the CPU path on a small input")

    fault_reference_phase(card_line, random.fold_in(key, 6), dev)

    # ---- 5. the main path ---------------------------------------------------
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=MU, sigma=SIGMA,
                indpb=INDPB)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)

    def fresh():
        return base.Population(genome.clone(),
                               base.Fitness.empty(POP, (-1.0,), device=dev))

    def run(ngen):
        pop0 = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pop, log = ea_simple(k_run, pop0, tb, CXPB, MUTPB, ngen,
                             stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t, pop, log

    run(2)                                     # warm the allocator
    kernels.reset_launches()
    t1, pop1, log1 = run(NGEN)
    launches_main = dict(kernels.LAUNCHES)
    t2, pop2, log2 = run(2 * NGEN)
    # the loop is host-bound on a shared host: repeat the (N, 2N) pair in
    # alternating order and report the median marginal cost
    pairs = [(t1, t2)]
    for i in range(TIMING_PAIRS - 1):
        if i % 2:
            a = run(NGEN)[0]
            b = run(2 * NGEN)[0]
        else:
            b = run(2 * NGEN)[0]
            a = run(NGEN)[0]
        pairs.append((a, b))
    marginals = sorted((b - a) / NGEN for a, b in pairs)
    per_gen = marginals[len(marginals) // 2]
    best = log2.select("min")
    final = pop2.fitness.values
    ok_shape = (tuple(pop2.genome.shape) == (POP, DIM)
                and bool(torch.isfinite(pop2.genome).all())
                and bool(torch.isfinite(final).all()))
    phase("main path: ea_simple megakernel rastrigin", card_line,
          pop=POP, dim=DIM, ngen=[NGEN, 2 * NGEN],
          seconds=[list(p) for p in pairs],
          marginal_ms_per_gen=per_gen * 1e3,
          marginal_ms_range=[marginals[0] * 1e3, marginals[-1] * 1e3],
          gens_per_s=1.0 / per_gen if per_gen > 0 else None,
          linearity=[b / a for a, b in pairs],
          best_start=best[0], best_end=best[-1],
          launches=launches_main,
          launches_per_gen={k: v / NGEN for k, v in launches_main.items()},
          finite_and_shaped=ok_shape)
    if launches_main["megakernel_gather_vary"] != NGEN:
        fail(f"K2 ran {launches_main['megakernel_gather_vary']} times in "
             f"{NGEN} generations of the main path")
    if not best[-1] < best[0]:
        fail(f"best fitness did not fall: {best[0]} -> {best[-1]}")
    if not ok_shape:
        fail("final population is not finite with shape (pop, dim)")

    # the serving step: a live prefix mask routes the generation through K1
    live = torch.arange(POP, device=dev) < POP - 4096
    pop = pop1
    kernels.reset_launches()
    skey = k_run
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LIVE_GENS):
        skey, pop, _ = ea_step(skey, pop, tb, CXPB, MUTPB, live=live)
    torch.cuda.synchronize()
    t_live = time.perf_counter() - t
    launches_live = dict(kernels.LAUNCHES)
    frozen = torch.equal(pop.genome[~live], pop1.genome[~live])
    phase("main path: ea_step live-mask (serving)", card_line, pop=POP,
          dim=DIM, gens=LIVE_GENS, ms_per_gen=t_live / LIVE_GENS * 1e3,
          launches=launches_live, pad_rows_frozen=frozen)
    if launches_live["megakernel_vary"] != LIVE_GENS:
        fail(f"K1 ran {launches_live['megakernel_vary']} times in "
             f"{LIVE_GENS} live-mask generations")
    if not frozen:
        fail("live-mask step changed pad rows")

    if "--profile" in sys.argv[1:]:
        profile_main_path(ea_step, k_run, pop1, tb, card_line)
    del pop1, pop2, pop, genome, values
    torch.cuda.empty_cache()

    # ---- 6./7. K3 and K4 against their plain versions ---------------------
    from deap_tpu_torch.ops import dominance as D
    k_k3, k_k3s, k_k4, k_ref, k_mo, k_head = random.split(
        random.fold_in(key, 2), 6)
    g_big = random.uniform(k_k3, (POP, DIM), minval=-5.12, maxval=5.12)
    k3_big = k3_phase(kernels, G, g_big, k_k3, card_line, POP, DIM,
                      (MU, SIGMA, INDPB), storages)
    del g_big
    g_mo = random.uniform(k_k3s, (MO_POP, MO_DIM))
    k3_mo = k3_phase(kernels, G, g_mo, k_k3s, card_line, MO_POP, MO_DIM,
                     (0.0, MO_SIGMA, MO_INDPB), storages)
    del g_mo
    # the vector walk's edges: rows of one vector, of a few, of many;
    # lambda != mu and not a multiple of a block's 256 rows
    k3_edges = {}
    for n, lam, dim in K3_EDGES:
        k_e = random.fold_in(k_k3s, dim)
        g_e = random.uniform(k_e, (n, dim), minval=-5.12, maxval=5.12)
        k3_edges[dim] = k3_phase(kernels, G, g_e, k_e, card_line, n, dim,
                                 (MU, SIGMA, INDPB), storages, lam=lam)
        del g_e
    k4 = k4_phase(kernels, D, k_k4, card_line)

    # ---- 8. an NSGA-II generation on a small input, card against CPU ------
    nsga2_reference_phase(card_line, k_ref)

    # ---- 9./10. the NSGA-II main path and the ea_step head ----------------
    launches_mo, mo_pop, mo_tb = nsga2_main_path(kernels, card_line, k_mo)
    launches_head, k1_head = nsga2_head_phase(kernels, G, card_line, k_head,
                                              mo_pop, mo_tb)
    if "--profile" in sys.argv[1:]:
        profile_nsga2(k_head, mo_pop, mo_tb, card_line)

    # ---- 11.-13. the GP slice: reference, main path, K6 -------------------
    del mo_pop
    torch.cuda.empty_cache()
    k_gp_ref, k_gp, k_gp_k6 = random.split(random.fold_in(key, 3), 3)
    gp_reference_phase(card_line, k_gp_ref, dev)
    launches_gp, launches_gp_ea, gp_pop2, gp_pop0, gp_tb = gp_main_path(
        kernels, card_line, k_gp, dev)
    if "--profile" in sys.argv[1:]:
        profile_gp(k_gp, gp_pop2, gp_tb, card_line)
    k6 = gp_k6_phase(kernels, card_line, k_gp_k6, gp_pop0, gp_pop2, dev)

    # ---- 14.-17. bench_nsga2.py as published, and K5 ----------------------
    del gp_pop0, gp_pop2
    torch.cuda.empty_cache()
    k_bn_ra, k_bn_rb, k_bn_a, k_bn_b, k_hv = random.split(
        random.fold_in(key, 4), 5)
    bench_nsga2_reference_phase(card_line, k_bn_ra, "dtlz2")
    bench_nsga2_reference_phase(card_line, k_bn_rb, "zdt1")
    launches_bn_a, bn_pop, bn_tb = bench_nsga2_main_path_a(kernels, card_line,
                                                           k_bn_a)
    if "--profile" in sys.argv[1:]:
        profile_bench_nsga2(k_bn_a, bn_pop, bn_tb, card_line)
    k5 = {"uniform": k5_check(
              kernels, card_line, f"{HV_UNIFORM_N} uniform points",
              random.uniform(k_hv, (HV_UNIFORM_N, 3)), (1.0, 1.0, 1.0)),
          "path A": k5_check(
              kernels, card_line, "path A's final population",
              -bn_pop.fitness.wvalues, HV_REF["dtlz2"])}
    del bn_pop
    torch.cuda.empty_cache()
    launches_bn_b = bench_nsga2_main_path_b(kernels, card_line, k_bn_b)

    # ---- 18.-21. the probe tools and P1-P5 --------------------------------
    k_pr, k_pr5 = random.split(random.fold_in(key, 5))
    p14 = probe_kernels_phase(card_line, k_pr)
    launches_pga = probe_ga_tool_phase(kernels, card_line)
    torch.cuda.empty_cache()
    p5, p5_edge_err = probe_gp_phase(card_line, k_pr5)
    launches_pgp, gp_probes = probe_gp_tool_phase(kernels, card_line)

    # ---- 22.-25. OneMax and CMA-ES: no kernel on their paths ---------------
    onemax_phase(card_line)
    cma_phase(card_line, "sphere")
    cma_phase(card_line, "ackley")
    cma_anchor_phase(card_line)
    mo_cma_phase(card_line)

    # ---- 26.-29. rbg keys: the samplers, the flagship, evopole ------------
    rbg_phase(card_line)
    launches_rbg = flagship_rbg_phase(kernels, card_line)
    onemax_phase(card_line, "rbg")
    cma_phase(card_line, "sphere", "rbg")
    evopole_phase(kernels, card_line)

    # ---- 30.-33. the rest of multi-objective --------------------------------
    torch.cuda.empty_cache()
    k_mo_ref, k_mo, k_dcd, k_spea = random.split(random.fold_in(key, 7), 4)
    permutation_phase(card_line)
    for i, problem in enumerate(BN_PROBLEMS):
        for j, name in enumerate(MO_SEL_PATHS):
            mo_select_reference(card_line, random.fold_in(k_mo_ref, 3 * i + j),
                                problem, name)
    mo_runs = {}
    for name, (_, problems) in MO_SEL_PATHS.items():
        for problem in problems:
            launches_p, ms_p, mo_pop = mo_select_main_path(
                kernels, card_line, random.fold_in(k_mo, len(mo_runs)),
                problem, name)
            mo_runs[f"{name} {problem}"] = launches_p
            if (name, problem) == ("nsga3", "dtlz2"):
                dcd_phase(card_line, k_dcd, mo_pop)
            del mo_pop
            torch.cuda.empty_cache()
    spea2_checks_phase(card_line, k_spea)
    launches_ex = examples_phase(kernels, card_line)

    # ---- 34.-38. the rest of GP ---------------------------------------------
    gp_rest = gp_rest_phases(kernels, card_line, key, dev)

    # ---- 34. the kernels line and the result -------------------------------
    # K1 and K2 at the GA flagship's shape (1e6 x 100 float32); K1's
    # launches are the live-mask path's, and per path beside them
    src = "deap_tpu_torch/kernels/megakernel.cu"
    rows = []
    for name, tag, replaces, launches in (
            ("megakernel_vary", "K1",
             "deap_tpu/ops/generation_pallas.py:519",
             launches_live["megakernel_vary"]),
            ("megakernel_gather_vary", "K2",
             "deap_tpu/ops/generation_pallas.py:441",
             launches_main["megakernel_gather_vary"])):
        err, ms, plain, b, by = report["float32"][tag][:5]
        errs = [report[d][tag][0] for d in report]
        if tag == "K1":
            errs += [v[0] for v in k1_head.values()]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None})
    rows[0]["launches_by_path"] = {
        "ea_step live-mask": launches_live["megakernel_vary"],
        "NSGA-II ea_step head": launches_head["megakernel_vary"],
        "ea_step live-mask, rbg keys": launches_rbg["K1"]}
    rows[1]["launches_by_path"] = {
        f"ea_simple, {NGEN} generations": launches_main[
            "megakernel_gather_vary"],
        f"ea_simple, rbg keys, {RBG_NGEN} generations": launches_rbg["K2"]}
    # K1 at the NSGA-II head's shape beside the flagship's: host-paced
    # ms, device ms with the launches queued, and the bound
    rows[0]["ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][1] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[1]
           for d, v in k1_head.items()}}
    rows[0]["device_ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][5] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[3]
           for d, v in k1_head.items()}}
    rows[0]["bound_ms_by_shape"] = {
        **{f"{POP} x {DIM} {d}": report[d]["K1"][3] for d in report},
        **{f"{MO_POP} x {MO_DIM} {d} (NSGA-II head)": v[4]
           for d, v in k1_head.items()}}
    # K3 at the NSGA-II path's shape (1e5 x 12 float32), and both shapes
    # by type
    err, ms, plain, b, by, dev_ms = k3_mo["float32"]
    k3_main = (((POP, DIM), k3_big), ((MO_POP, MO_DIM), k3_mo))
    rows.append({
        "name": "megakernel_var_or", "route": "cuda", "source": src,
        "replaces": "deap_tpu/ops/generation_pallas.py:566",
        "launches": launches_mo["megakernel_var_or"],
        "max_abs_err": max(v[0] for d in (k3_big, k3_mo, *k3_edges.values())
                           for v in d.values()),
        "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
        "library_ms": None, "device_ms": dev_ms,
        "ms_by_shape": {f"{n} x {dm} {d}": v[1] for (n, dm), k3 in k3_main
                        for d, v in k3.items()},
        "device_ms_by_shape": {f"{n} x {dm} {d}": v[5]
                               for (n, dm), k3 in k3_main
                               for d, v in k3.items()}})
    # K4 at its C = n call
    err, ms, plain, b, by = k4[2 * MO_POP]
    rows.append({
        "name": "rows_dominate_counts", "route": "cuda",
        "source": "deap_tpu_torch/kernels/dominance.cu",
        "replaces": "deap_tpu/ops/dominance_pallas.py:77",
        "launches": launches_mo["rows_dominate_counts"],
        "max_abs_err": max(v[0] for v in k4.values()),
        "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
        "library_ms": None,
        "launches_by_path": {
            "NSGA-II ea_mu_plus_lambda": launches_mo["rows_dominate_counts"],
            "NSGA-II ea_step head": launches_head["rows_dominate_counts"],
            "bench_nsga2 A (grid peel)":
                launches_bn_a["rows_dominate_counts"],
            "bench_nsga2 B": launches_bn_b["rows_dominate_counts"],
            **{f"bench_nsga2 {path}": v["rows_dominate_counts"]
               for path, v in mo_runs.items()},
            **{f"examples/ga/{ex}.py": v["rows_dominate_counts"]
               for ex, v in launches_ex.items()}}})
    # K5 in float64 (the toolbox slot's route) on path A's final
    # population; its other inputs and float32 are in the K5 phases above
    a64 = k5["path A"]["float64"]
    rows.append({
        "name": "hv3d_sweep", "route": "cuda",
        "source": "deap_tpu_torch/kernels/hypervolume.cu",
        "replaces": "deap_tpu/ops/hypervolume.py:161",
        "launches": launches_bn_a["hv3d_sweep"],
        "max_abs_err": max(v["max_abs_err"] for c in k5.values()
                           for v in c.values()),
        "ms": a64["ms"], "plain_ms": a64["plain_ms"],
        "bound_ms": a64["bound_ms"], "bound_by": a64["bound_by"],
        "library_ms": None,
        "ms_by_input": {f"{c} {d}": v["ms"] for c, cs in k5.items()
                        for d, v in cs.items()},
        "device_ms_by_input": {f"{c} {d}": v["device_ms"]
                               for c, cs in k5.items()
                               for d, v in cs.items()}})
    # K6 on the population after 2N generations of the main path (its
    # other inputs are in the K6 phases above)
    ev = k6["evolved"]
    rows.append({
        "name": "gp_interp", "route": "cuda",
        "source": "deap_tpu_torch/kernels/gp_interp.cu",
        "replaces": "deap_tpu/gp/interp_pallas.py:201",
        "launches": launches_gp["gp_interp"],
        "max_abs_err": max(v["max_abs_err"] for v in (
            *k6.values(), *gp_rest["k6_children"].values())),
        "ms": ev["ms"], "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": None,
        "launches_by_path": {
            "bench generation": launches_gp["gp_interp"],
            "ea_simple": launches_gp_ea["gp_interp"],
            f"HARM, {2 * HARM_NGEN} generations": gp_rest["harm"],
            **{f"bench generation, {v}, {2 * GP_VARIANT_NGEN} generations":
               n for v, n in gp_rest["variants"].items()},
            "bench generation, automatic epsilon-lexicase": gp_rest[
                "lexicase"],
            **{f"examples/gp/{ex}.py": v["gp_interp"]
               for ex, v in gp_rest["examples"].items()}},
        "ms_by_input": {**{k: v["ms"] for k, v in k6.items()},
                        **{f"children of {k}": v["ms"]
                           for k, v in gp_rest["k6_children"].items()}},
        "device_ms_by_input": {
            **{k: v["device_ms"] for k, v in k6.items()},
            **{f"children of {k}": v["device_ms"]
               for k, v in gp_rest["k6_children"].items()}},
        "bound_ms_by_input": {
            **{k: v["bound_ms"] for k, v in k6.items()},
            **{f"children of {k}": v["bound_ms"]
               for k, v in gp_rest["k6_children"].items()}}})
    rows[-1]["launches_by_path"]["probes.gp real63"] = launches_pgp[
        "gp_interp"]
    # P1-P4 at the GA tool's shape (stream and the row tiles at 2048
    # rows), launches on the GA tool's path; P5 at the GP tool's shape,
    # dispatch at tb 8, unroll 1 (its other forms are in phase 20),
    # launches on the GP tool's path
    ga_src = "tools/pallas_probe_ga.py"
    for name, tag, line in (
            ("probe_stream_copy", "stream_rows2048", 280),
            ("probe_chain24", "chain", 280),
            ("probe_rast_reduce", "rast", 280),
            ("probe_hash_normal", "rng", 354),
            ("probe_lookup", "lookup", 421),
            ("probe_row_gather", "dmagather", 479)):
        r = p14[tag]
        rows.append({
            "name": name, "route": "cuda",
            "source": "deap_tpu_torch/kernels/probes.cu",
            "replaces": f"{ga_src}:{line}", "launches": launches_pga[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    rows[-6]["ms_by_rows"] = {k: v["ms"] for k, v in p14.items()
                              if k.startswith("stream_")}
    rows[-6]["library_ms_by_rows"] = {k: v["library_ms"]
                                      for k, v in p14.items()
                                      if k.startswith("stream_")}
    rows[-6]["tb_per_s_by_rows"] = {k: v["tb_per_s"] for k, v in p14.items()
                                    if k.startswith("stream_")}
    rows[-4]["device_ms"] = p14["rast"]["device_ms"]
    rows[-2]["device_ms"] = p14["lookup"]["device_ms"]
    rows[-2]["library_device_ms"] = p14["lookup"]["library_device_ms"]
    r5 = p5[("dispatch", 8, 0)]
    rows.append({
        "name": "probe_gp", "route": "cuda",
        "source": "deap_tpu_torch/kernels/probes.cu",
        "replaces": "tools/pallas_probe_gp.py:184",
        "launches": launches_pgp["probe_gp"],
        "max_abs_err": max(p5_edge_err,
                           *(v["max_abs_err"] for v in p5.values())),
        "ms": r5["ms"], "plain_ms": r5["plain_ms"], "bound_ms": r5["bound_ms"],
        "bound_by": r5["bound_by"], "library_ms": None,
        "ms_by_form": {f"{m} tb{tb} unroll{u or 1}": v["ms"]
                       for (m, tb, u), v in p5.items()},
        "fraction_of_floor": gp_probes.get("fraction_of_floor")})

    phase("total", card_line, seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
