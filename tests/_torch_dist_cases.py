"""Rank-side cases of the port's distribution tests.

``tests/test_torch_parallel.py``, ``test_torch_emo_sharded.py`` and
``test_torch_dist_examples.py`` start ``R`` gloo ranks with
:func:`deap_tpu_torch.parallel.launch.run_ranks`; each rank runs one of
the functions below (all of a file's cases in one launch, so each rank
imports torch once) and returns plain tensors, gathered where a case's
output is sharded.  This module imports only numpy, torch and the port:
the JAX oracles run in the test process, on the same inputs, which the
``*_inputs`` helpers make from numpy seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from deap_tpu_torch import algorithms, base, benchmarks, random
from deap_tpu_torch.ops import crossover, hypervolume, mutation, selection
from deap_tpu_torch.parallel import (ShardedPopulation, collectives,
                                     ea_simple_islands, fetch_global,
                                     initialize_cluster, population_sharding,
                                     process_count, process_index,
                                     shard_population, tpu_map)
from deap_tpu_torch.parallel import emo_sharded as E
from deap_tpu_torch.ops import generation_sharded as GS
from deap_tpu_torch.utils import checkpoint as ck
from deap_tpu_torch.utils.support import Statistics

# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

GEN_N, GEN_DIM = 256, 12                 # the sharded megakernel cases
PAD_N = 200                              # not a multiple of R x 32
KNOBS = dict(cxpb=0.9, mutpb=0.5, mut_mu=0.0, mut_sigma=0.3, indpb=0.05)
ONEMAX_N, ONEMAX_BITS, ONEMAX_GEN = 128, 60, 8
MU_N, LAMBDA_N, MU_GEN = 64, 96, 5        # the (mu +/, lambda) loops
#: the sharded xla loops with operators that have no batched form: each
#: row's ``(dim,)`` draws share their size with a rank's mating pairs at
#: R = 2 (32 rows, 16 pairs) and with its rows at R = 4 (and with a
#: rank's 16 of the 64 children of ``ea_mu_plus_lambda`` there)
ROW_OP_N, ROW_OP_DIM, ROW_OP_GEN = 64, 16, 4
ISL, ISL_POP, ISL_BITS, ISL_GEN = 4, 32, 20, 6
MIGARRAYS = (None, (2, 0, 3, 1))
HV_N = 301
MAP_N = 37
CKPT_N = 100
#: (n, m, k, front_chunk) of the sharded NSGA-II cases; k None ranks all
EMO_CASES = ((512, 3, 256, 256), (301, 3, 150, 7), (512, 2, 256, 256),
             (256, 3, None, 2), (96, 4, 40, 5))


def gen_inputs():
    """``(genome (GEN_N, GEN_DIM) float32, wvalues (GEN_N, 1))`` with
    ties in the fitness."""
    rng = np.random.default_rng(11)
    g = rng.uniform(-5.12, 5.12, (GEN_N, GEN_DIM)).astype(np.float32)
    w = np.round(rng.normal(size=(GEN_N, 1)) * 4).astype(np.float32)
    return g, w


def mo_cloud(seed: int, n: int, m: int) -> np.ndarray:
    """A DTLZ2-shaped maximisation cloud (``tests/test_parallel.py``'s
    ``_mo_cloud``, drawn with numpy), with a few exact duplicates."""
    x = np.random.default_rng(seed).random((n, m), dtype=np.float32)
    cols = [x[:, 0]] + [x[:, j] * (np.float32(1.5) - x[:, 0])
                        for j in range(1, m)]
    w = -np.stack(cols, axis=1)
    w[n // 3] = w[n // 5]
    return w


def hv_inputs():
    rng = np.random.default_rng(5)
    p3 = rng.random((HV_N, 3))
    p2 = rng.random((HV_N, 2))
    return p3, p2


def map_inputs():
    """Integer-valued rows: a sum of squares is exact in any order."""
    return np.round(np.random.default_rng(3).normal(size=(MAP_N, 5)) * 8
                    ).astype(np.float32)


def mk_toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.3,
                indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    return tb


def onemax_toolbox(indpb=0.05):
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (g.sum(),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=indpb)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def row_op_toolbox(kind: str):
    """``"per-row"``: ``cx_two_point`` and ``mut_flip_bit`` behind
    lambdas, so the loop calls them a row at a time; ``"rowwise"``: the
    rowwise UPMX and ``mut_shuffle_indexes`` on permutations."""
    tb = base.Toolbox()
    tb.register("select", selection.sel_tournament, tournsize=3)
    if kind == "per-row":
        tb.register("evaluate", lambda g: (g.sum(),))
        tb.register("mate", lambda k, a, b: crossover.cx_two_point(k, a, b))
        tb.register("mutate",
                    lambda k, g: mutation.mut_flip_bit(k, g, indpb=0.2))
        return tb
    w = torch.arange(ROW_OP_DIM, dtype=torch.float32)
    tb.register("evaluate", lambda g: ((g.to(torch.float32) * w).sum(),))
    tb.register("mate", crossover.cx_uniform_partialy_matched, indpb=0.3)
    tb.register("mutate", mutation.mut_shuffle_indexes, indpb=0.2)
    return tb


def row_op_start(kind: str):
    """``(k_run, population)`` of the per-row operator cases: random bits,
    or numpy-drawn permutations of ``ROW_OP_DIM``."""
    k_init, k_run = random.split(random.PRNGKey(13, device="cpu"))
    if kind == "per-row":
        g = random.bernoulli(k_init, 0.5, (ROW_OP_N, ROW_OP_DIM)).to(
            torch.float32)
    else:
        g = torch.from_numpy(np.random.default_rng(13).permuted(
            np.tile(np.arange(ROW_OP_DIM, dtype=np.int32), (ROW_OP_N, 1)),
            axis=1))
    return k_run, base.Population(g, base.Fitness.empty(
        ROW_OP_N, (1.0,), device="cpu"))


def onemax_stats():
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("max", torch.max)
    stats.register("min", torch.min)
    return stats


def onemax_start(device="cpu"):
    """``(k_run, population)`` of ``test_sharded_ea_simple_bit_identical``
    (``PRNGKey(2)`` split into the draw's key and the run's)."""
    k_init, k_run = random.split(random.PRNGKey(2, device=device))
    g = random.bernoulli(k_init, 0.5, (ONEMAX_N, ONEMAX_BITS)).to(
        torch.float32)
    return k_run, base.Population(g, base.Fitness.empty(
        ONEMAX_N, (1.0,), device=device))


def islands_start(device="cpu"):
    k_init, k_run = random.split(random.PRNGKey(5, device=device))
    g = random.bernoulli(k_init, 0.5, (ISL, ISL_POP, ISL_BITS)).to(
        torch.float32)
    return k_run, base.Population(g, base.Fitness(
        torch.zeros((ISL, ISL_POP, 1), device=device),
        torch.zeros((ISL, ISL_POP), dtype=torch.bool, device=device),
        (1.0,)))


def ckpt_population(n=CKPT_N):
    g = random.uniform(random.PRNGKey(1, device="cpu"), (n, 5))
    return base.Population(g, base.Fitness(
        g[:, :2].clone(), torch.arange(n) % 3 == 0, (1.0, -1.0)))


def mo_population():
    """GEN_N rows of the generation's genome with three-objective
    fitness (``mo_cloud``, minimised)."""
    pop = mk_population(GEN_N)
    vals = torch.from_numpy(-mo_cloud(7, GEN_N, 3))
    return base.Population(pop.genome, base.Fitness(
        vals, torch.ones(GEN_N, dtype=torch.bool), (-1.0,) * 3))


def mk_population(n):
    g, w = gen_inputs()
    reps = -(-n // GEN_N)
    g = np.concatenate([g] * reps)[:n]
    return base.Population(torch.from_numpy(g), base.Fitness.empty(
        n, (-1.0,), device="cpu"))


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def _rows(x, sh):
    return torch.as_tensor(x)[sh.start:sh.stop]


def _gathered_rows(x, mesh, sh):
    pad = sh.n_loc - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)
    return collectives.all_gather(x.contiguous(), mesh)[:sh.n]


def parallel_cases(mesh, ckpt_dir: str, save: bool) -> dict:
    """Every case of ``tests/test_torch_parallel.py`` on this rank."""
    out = {"rank": mesh.rank, "size": mesh.size}
    initialize_cluster()                           # a second call: no-op
    out["process"] = (process_index(), process_count())

    # the row-range draw: this rank's rows of a (48, 3) normal draw
    sh = population_sharding(mesh, 48, 2)
    k = random.PRNGKey(7, device="cpu")
    with random.row_range((48, sh.start, sh.stop)):
        block = random.normal(k, (sh.rows, 3))
    out["row_range"] = _gathered_rows(block, mesh, sh)

    # tpu_map: pad=True, pad=int, pad=False
    g = torch.from_numpy(map_inputs())
    f = lambda x: (x * x).sum()                    # noqa: E731
    out["map"] = tpu_map(f, g, mesh=mesh)
    out["map_int"] = tpu_map(f, g, mesh=mesh, pad=8)
    try:
        tpu_map(f, g, mesh=mesh, pad=False)
        out["map_strict"] = "ran"
    except ValueError as e:
        out["map_strict"] = str(e)

    # the sharded megakernel generation, both gathers
    gen_g, gen_w = gen_inputs()
    sh = population_sharding(mesh, GEN_N, 32)
    keys = random.split(random.PRNGKey(3, device="cpu"), 2)
    for gather in ("dma", "host"):
        new, widx = GS.fused_generation_sharded(
            keys[0], keys[1], _rows(gen_g, sh), _rows(gen_w, sh), mesh=mesh,
            dim=GEN_DIM, gather=gather, **KNOBS)
        out[f"gen_{gather}"] = (_gathered_rows(new, mesh, sh),
                                _gathered_rows(widx, mesh, sh))

    # fused_ea_step_sharded: padded (PAD_N rows) and a live mask
    tb = mk_toolbox()
    tb.generation_mesh = mesh
    k_step = random.PRNGKey(4, device="cpu")
    pop = mk_population(PAD_N)
    pop = base.Population(pop.genome, pop.fitness.with_values(
        torch.from_numpy(-np.resize(gen_w, (PAD_N, 1)))))
    sp = shard_population(pop, mesh, quantum=32)
    _, new = GS.fused_ea_step_sharded(k_step, sp, tb, 0.9, 0.5)
    out["step_pad"] = fetch_global(new).genome
    pop = mk_population(GEN_N)
    pop = base.Population(pop.genome, pop.fitness.with_values(
        torch.from_numpy(-gen_w)))
    sp = shard_population(pop, mesh, quantum=32)
    live = (torch.arange(GEN_N) < PAD_N)[sp.sharding.start:sp.sharding.stop]
    _, new = GS.fused_ea_step_sharded(k_step, sp, tb, 0.9, 0.5, live=live)
    out["step_live"] = fetch_global(new).genome

    # the sharded NSGA-II head of the megakernel engine
    tb_mo = mk_toolbox()
    tb_mo.register("select", E.sel_nsga2_sharded, mesh=mesh)
    tb_mo.generation_mesh = mesh
    sp = shard_population(mo_population(), mesh, quantum=32)
    _, new = GS.fused_nsga2_step_sharded(random.PRNGKey(6, device="cpu"), sp,
                                         tb_mo, 0.9, 0.5)
    out["nsga2_head"] = fetch_global(new).genome
    _, new = algorithms.ea_ask(random.PRNGKey(6, device="cpu"), sp, tb_mo,
                               0.9, 0.5)
    out["nsga2_head_ask"] = fetch_global(new).genome

    # ea_simple on the megakernel_sharded engine
    sp = shard_population(mk_population(GEN_N), mesh, quantum=32)
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    final, log = algorithms.ea_simple(random.PRNGKey(9, device="cpu"), sp,
                                      tb, 0.9, 0.5, 3, stats=stats)
    out["ea_mk"] = (fetch_global(final).genome, log.select("min"))

    # ea_simple on the xla engine: OneMax, stats and a hall of fame
    from deap_tpu_torch.utils.support import HallOfFame
    k_run, pop = onemax_start()
    sp = shard_population(pop, mesh, quantum=2)
    hof = HallOfFame(3)
    final, log = algorithms.ea_simple(k_run, sp, onemax_toolbox(), 0.5, 0.2,
                                      ONEMAX_GEN, stats=onemax_stats(),
                                      halloffame=hof)
    full = fetch_global(final)
    out["ea_xla"] = (full.genome, full.fitness.values, log.select("max"),
                     log.select("nevals"), hof.state.genome)

    # the xla loop with operators that have no batched form
    for kind in ("per-row", "rowwise"):
        k_run, pop = row_op_start(kind)
        sp = shard_population(pop, mesh, quantum=2)
        final, log = algorithms.ea_simple(k_run, sp, row_op_toolbox(kind),
                                          0.6, 0.4, ROW_OP_GEN,
                                          stats=onemax_stats())
        full = fetch_global(final)
        out[("row_op", kind)] = (full.genome, full.fitness.values,
                                 log.select("max"))
        sp = shard_population(pop.take(torch.arange(ROW_OP_N // 2)), mesh,
                              quantum=2)
        final, log = algorithms.ea_mu_plus_lambda(
            k_run, sp, row_op_toolbox(kind), ROW_OP_N // 2, ROW_OP_N, 0.5,
            0.3, ROW_OP_GEN, stats=onemax_stats())
        full = fetch_global(final)
        out[("row_op_mu", kind)] = (full.genome, log.select("max"))

    # the (mu + lambda) and (mu, lambda) loops on a sharded population
    for plus in (True, False):
        k_run, pop = onemax_start()
        sp = shard_population(pop.take(torch.arange(MU_N)), mesh, quantum=2)
        loop = (algorithms.ea_mu_plus_lambda if plus
                else algorithms.ea_mu_comma_lambda)
        final, log = loop(k_run, sp, onemax_toolbox(), MU_N, LAMBDA_N, 0.5,
                          0.3, MU_GEN, stats=onemax_stats())
        full = fetch_global(final)
        out[("mu_lambda", plus)] = (full.genome, full.fitness.values,
                                    log.select("max"), log.select("nevals"))

    # islands with cross-rank migration (a ring, and a non-cyclic map)
    if ISL % mesh.size == 0:
        for mig in MIGARRAYS:
            k_run, pops = islands_start()
            res, recs = ea_simple_islands(
                k_run, pops, onemax_toolbox(), 0.6, 0.3, ISL_GEN,
                mig_freq=2, mig_k=3, migarray=mig, mesh=mesh)
            out[("islands", mig)] = (
                collectives.all_gather(res.genome, mesh),
                collectives.all_gather(res.fitness.values, mesh),
                recs["nevals"])

    # hypervolume_sharded: d = 3 in float32 and float64, d = 2
    p3, p2 = hv_inputs()
    sh = population_sharding(mesh, HV_N)
    for name, pts in (("hv3_f32", p3.astype(np.float32)), ("hv3_f64", p3),
                      ("hv2_f64", p2)):
        out[name] = hypervolume.hypervolume_sharded(
            _rows(pts, sh), [1.0] * pts.shape[1], mesh, n=HV_N)

    # the sharded checkpoint: saved at R = 2, loaded at any R
    if save:
        sp = shard_population(ckpt_population(), mesh, quantum=2)
        ck.save_sharded_checkpoint(ckpt_dir, {
            "key": random.PRNGKey(5, device="cpu"), "population": sp,
            "gen": 7})
    else:
        like = {"key": random.PRNGKey(0, device="cpu"),
                "population": shard_population(ckpt_population(), mesh),
                "gen": 0}
        st = ck.load_sharded_checkpoint(ckpt_dir, like)
        loaded = st["population"]
        out["ckpt"] = (st["key"], fetch_global(loaded), st["gen"],
                       tuple(loaded.genome.shape),
                       isinstance(loaded, ShardedPopulation))
    return out


def emo_cases(mesh) -> dict:
    """Every case of ``tests/test_torch_emo_sharded.py`` on this rank:
    counts, ranks and selections, gathered where they are per row."""
    out = {}
    for n, m, k, c in EMO_CASES:
        w = torch.from_numpy(mo_cloud(n + m, n, m))
        sh = population_sharding(mesh, n)
        wl = w[sh.start:sh.stop]
        res = {"counts": _gathered_rows(
            E.dominance_counts_sharded(wl, mesh, n=n), mesh, sh)}
        for method, ex in (("peel", "indices"), ("peel", "rows"),
                           ("grid", "indices")):
            r, nf = E.nondominated_ranks_sharded(
                wl, mesh, front_chunk=c, stop_at_k=k, exchange=ex,
                method=method, n=n)
            res[(method, ex)] = (_gathered_rows(r, mesh, sh), nf)
        if k is not None:
            vals = -wl
            fit = base.Fitness(vals, torch.ones(vals.shape[0], dtype=bool),
                               (-1.0,) * m)
            for ranks in ("peel", "grid"):
                for tail in ("sharded", "replicated"):
                    for ex in ("indices", "rows"):
                        res[("sel", ranks, tail, ex)] = E.sel_nsga2_sharded(
                            None, fit, k, mesh, front_chunk=c, exchange=ex,
                            ranks=ranks, tail=tail, n=n)
        out[(n, m, k, c)] = res
    return out


def island_example(mesh, ngen: int) -> tuple:
    """``onemax_island.main`` in its ``mesh=`` form."""
    from deap_tpu_torch.examples.ga import onemax_island
    pops = onemax_island.main(seed=0, mesh=mesh, ngen=ngen, verbose=False)
    return (collectives.all_gather(pops.genome, mesh),
            collectives.all_gather(pops.fitness.values, mesh))


def sharded_example(mesh, ngen: int, pop_size: int) -> tuple:
    """``onemax_sharded.main`` on this mesh, gathered."""
    from deap_tpu_torch.examples.ga import onemax_sharded
    pop = onemax_sharded.main(seed=0, pop_size=pop_size, ngen=ngen,
                              mesh=mesh, verbose=False)
    full = fetch_global(pop)
    return full.genome, full.fitness.values


# ---------------------------------------------------------------------------
# a one-rank mesh inside the test process
# ---------------------------------------------------------------------------


import contextlib  # noqa: E402


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A mesh of one gloo rank in this process (a ``file://`` rendezvous
    under ``tmp_path``), the process group destroyed on exit."""
    import torch.distributed as dist
    from deap_tpu_torch.parallel import default_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield default_mesh(device="cpu", timeout=30)
    finally:
        dist.destroy_process_group()


def fail_on_rank_one(mesh):
    """Rank 1 fails at once; the others wait in a collective it never
    joins (the launcher must kill them)."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    collectives.barrier(mesh)
    return mesh.rank
