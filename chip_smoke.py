#!/usr/bin/env python3
"""Drive deap_tpu_torch on one NVIDIA card and check it, phase by phase.

    python3 chip_smoke.py

1. build   — compile the port's CUDA kernels from the checkout's source
             and bind them;
2. K1      — ``megakernel_vary`` against its plain PyTorch version on the
             card, pop 1e6 x dim 100, float32 / bfloat16 / int8 storage;
3. K2      — ``megakernel_gather_vary`` against ``index_select`` plus the
             plain variation, same sizes;
4. reference — one whole fused generation on a small input: the card's
             output against the CPU path's, bit for bit;
5. main path — ``ea_simple`` with the megakernel engine on rastrigin, pop
             1e6 x dim 100 float32, NGEN and 2*NGEN generations, five
             pairs (median marginal time per generation), best fitness
             must fall; then
             the serving step (``ea_step`` with a live mask) for a few
             generations.  Launch counts are zeroed before each of the two
             and read after: each kernel must have run on its path.
6. the ``kernels`` line, the card's name and power limit, and the result
   line.

``python3 chip_smoke.py --profile`` adds, after phase 5, a
``torch.profiler`` breakdown of a main-path generation.

Tolerance: every kernel must equal its plain version bit for bit (the
stated ulp bound is 0); a mismatch prints the measured bound and fails.
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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# Instruction rates of the H100 SXM: 132 SMs at the 1.98 GHz that the
# data sheet's 67 TFLOP/s float32 peak implies (132 x 128 lanes x 2 x
# 1.98e9).  Per SM and clock: 128 float32 instructions (an FMA is one,
# hence half the FLOP rate), 64 INT32 instructions (Hopper whitepaper),
# and 128 instructions issued in all.
FP32_INSTR_PER_S = 67e12 / 2
INT32_INSTR_PER_S = 67e12 / 4
ISSUE_PER_S = 67e12 / 2
ULP_BOUND = 0                      # kernels equal their plain versions
CXPB, MUTPB, MU, SIGMA, INDPB = 0.9, 0.5, 0.0, 0.3, 0.05


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase(name: str, card_line: str, **fields) -> None:
    print(json.dumps({"phase": name, "card": card_line, **fields}),
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


def bound_ms(n_bytes: float, ops):
    """The least time for moving ``n_bytes`` and issuing ``ops`` =
    ``(integer, float)`` instructions: the larger of the byte time and
    the slowest of the integer pipe, the float pipe and the issue slots."""
    ints, flts = ops
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ints / INT32_INSTR_PER_S, flts / FP32_INSTR_PER_S,
                (ints + flts) / ISSUE_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def profile_main_path(ea_step, key, pop, tb, card_line, gens=5) -> None:
    """``--profile``: where a main-path generation's time goes — the wall
    cost of each stage called alone, then ``torch.profiler`` over
    ``gens`` generations: device busy time and kernel launches against
    the wall clock, and device time by operator."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(gens):
            key, pop, _ = ea_step(key, pop, tb, CXPB, MUTPB)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA
               and dev_us(e) > 0]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU
           and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    top = sorted(ops, key=dev_us, reverse=True)[:12]
    phase("profile: ea_step megakernel, per generation", card_line,
          gens=gens, wall_ms=wall / gens * 1e3,
          device_busy_ms=(busy_us / gens / 1e3 if busy_us
                          else "not measured"),
          device_idle_share=(1.0 - busy_us / 1e6 / wall if busy_us
                             else "not measured"),
          kernel_launches=sum(e.count for e in kernels) / gens,
          top_ops=[{"op": e.key[:48], "ms": dev_us(e) / gens / 1e3,
                    "calls": e.count / gens} for e in top])


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py needs a card")
    card_line = card()
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

        def plain_vary():
            return G._narrow(G._vary_tile_plain(
                G._widen(parents, st.dtype, st.scale), seed, knobs, DIM),
                st.dtype, st.scale)

        k1 = kernels.launch_vary(parents, seed, knobs, dim=DIM,
                                 dtype=st.dtype, scale=st.scale)
        p1 = plain_vary()
        torch.cuda.synchronize()
        gap1 = ulp_gap(k1, p1)
        err1 = float((k1.float() - p1.float()).abs().max().item())
        ms1 = cuda_ms(lambda: kernels.launch_vary(
            parents, seed, knobs, dim=DIM, dtype=st.dtype, scale=st.scale))
        plain1 = cuda_ms(plain_vary, reps=3, warm=1)
        ops = tile_ops(counts, POP, DIM, st.dtype)
        b1, by1 = bound_ms(2 * POP * DIM * elt + 4 + 20, ops)
        phase("K1 megakernel_vary vs plain", card_line, storage=st.dtype,
              ulp_gap=gap1, ulp_bound=ULP_BOUND, max_abs_err=err1,
              ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
              shape=[POP, DIM])
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
        b2, by2 = bound_ms(2 * POP * DIM * elt + 3 * 4 * POP + 4 + 20, ops)
        phase("K2 megakernel_gather_vary vs index_select+plain", card_line,
              storage=st.dtype, ulp_gap=gap2, ulp_bound=ULP_BOUND,
              max_abs_err=err2, widx_equal=True, ms=ms2, plain_ms=plain2,
              bound_ms=b2, bound_by=by2, shape=[POP, DIM])
        if gap2 > ULP_BOUND:
            fail(f"K2 {st.dtype}: {gap2} ulp from its plain version "
                 f"(bound {ULP_BOUND})")
        report[st.dtype] = {"K1": (err1, ms1, plain1, b1, by1),
                            "K2": (err2, ms2, plain2, b2, by2)}
        del gs, parents, k1, p1, k2, p2
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

    # ---- 6. the kernels line and the result --------------------------------
    src = "deap_tpu_torch/kernels/megakernel.cu"
    rows = []
    for name, tag, replaces, launches in (
            ("megakernel_vary", "K1",
             "deap_tpu/ops/generation_pallas.py:519",
             launches_live["megakernel_vary"]),
            ("megakernel_gather_vary", "K2",
             "deap_tpu/ops/generation_pallas.py:441",
             launches_main["megakernel_gather_vary"])):
        err, ms, plain, b, by = report["float32"][tag]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(report[d][tag][0] for d in report),
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
