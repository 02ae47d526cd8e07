"""The port's distribution slice (``deap_tpu_torch.parallel``, the
sharded megakernel, ``hypervolume_sharded``, the sharded checkpoint)
against the JAX package on an R-device sub-mesh of the 8 virtual CPU
devices, and against the port's single-device path.

The port runs SPMD: R gloo rank processes (``_torch_dist_cases.
parallel_cases``, one launch per R with every case), each holding its
block of rows; their outputs come back gathered.  Every integer and
genome output is compared bit for bit; the float32 sharded
hypervolume within :data:`HV32_ULP` ulp of JAX's, the float64 one
within 1e-11 (relative) of the host truth."""

import os
import pathlib

import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import random as trandom
from deap_tpu_torch.ops import generation as TG
from deap_tpu_torch.ops import hypervolume as thv
from deap_tpu_torch.parallel import launch, mapper, multihost
from deap_tpu_torch.utils import checkpoint as tck

RANKS = (1, 2, 4)
#: the port's float32 sharded 3-D hypervolume against the JAX
#: function's body on the same mesh size (:func:`_jax_hv_sharded_f32`):
#: measured 2, 2 and 0 ulp at R = 1, 2, 4 (per-slab sums in another
#: order than XLA's); the bound, in ulp
HV32_ULP = 4
TESTS = str(pathlib.Path(__file__).resolve().parent)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{R: [rank outputs]}``: the checkpoint is saved by the R = 2
    launch and loaded by the R = 1 and R = 4 launches."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    env = dict(os.environ, PYTHONPATH=TESTS)
    out = {}
    for R in (2, 1, 4):
        out[R] = launch.run_ranks(
            "_torch_dist_cases:parallel_cases", R, kwargs=dict(
                ckpt_dir=ckpt, save=R == 2), env=env, timeout=60,
            deadline=240, threads=2, workdir=tmp_path_factory.mktemp(f"r{R}"))
    return out


def _jmesh(R, axis="pop"):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:R]), (axis,))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.view(np.uint8) == b.view(np.uint8)).all() if a.dtype.kind == "f" \
        else np.array_equal(a, b)


# ---------------------------------------------------------------------------
# multihost, mapper, collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", RANKS)
def test_cluster_second_call_is_a_noop(ranks, R):
    for r, o in enumerate(ranks[R]):
        assert o["process"] == (r, R)
        assert (o["rank"], o["size"]) == (r, R)


def test_initialize_cluster_env_rules(monkeypatch):
    for k in ("DEAP_TPU_COORDINATOR", "DEAP_TPU_NPROC", "DEAP_TPU_PROC_ID",
              "JAX_COORDINATOR", "NPROC", "PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    res = multihost._resolve
    assert res(None, None, None) == (None, None, None)
    # a stray NPROC (make -j$NPROC) without JAX_COORDINATOR is ignored
    monkeypatch.setenv("NPROC", "8")
    monkeypatch.setenv("PROC_ID", "3")
    assert res(None, None, None) == (None, None, None)
    monkeypatch.setenv("DEAP_TPU_COORDINATOR", "h:1")
    monkeypatch.setenv("DEAP_TPU_NPROC", "2")
    monkeypatch.setenv("DEAP_TPU_PROC_ID", "1")
    assert res(None, None, None) == ("h:1", 2, 1)
    assert res("x:2", 4, 0) == ("x:2", 4, 0)         # explicit wins
    # the legacy names count only as a set, with JAX_COORDINATOR present
    for k in ("DEAP_TPU_COORDINATOR", "DEAP_TPU_NPROC", "DEAP_TPU_PROC_ID"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("JAX_COORDINATOR", "j:3")
    assert res(None, None, None) == ("j:3", 8, 3)
    # configuration errors are never retried and never fall back
    with pytest.raises(ValueError, match="coordinator"):
        monkeypatch.delenv("JAX_COORDINATOR")
        multihost.initialize_cluster(num_processes=2, connect_attempts=3)


def test_initialize_cluster_retries_with_doubling_backoff(monkeypatch):
    """A failed connection is retried ``connect_attempts - 1`` times with
    the backoff doubling; the last failure propagates."""
    import torch.distributed as dist
    calls, sleeps = [], []

    def flaky(**kwargs):
        calls.append(kwargs)
        if len(calls) < 3:
            raise RuntimeError("connection refused")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", flaky)
    monkeypatch.setattr(multihost.time, "sleep", sleeps.append)
    multihost.initialize_cluster("127.0.0.1:1", 2, 0, connect_attempts=4,
                                 connect_backoff=0.5, backend="gloo")
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    assert calls[0]["init_method"] == "tcp://127.0.0.1:1"
    assert (calls[0]["world_size"], calls[0]["rank"]) == (2, 0)
    calls.clear()
    sleeps.clear()
    with pytest.raises(RuntimeError, match="refused"):
        multihost.initialize_cluster("127.0.0.1:1", 2, 0, connect_attempts=2,
                                     connect_backoff=0.5, backend="gloo")
    assert len(calls) == 2 and sleeps == [0.5]


def test_a_failed_rank_stops_the_others_quickly(tmp_path):
    """One rank fails while the others wait in a collective: the launcher
    kills them and raises with the failed rank's output, within seconds
    and long before the group's timeout."""
    import time
    t = time.monotonic()
    with pytest.raises(launch.RankFailure, match="rank 1 fails on purpose"):
        launch.run_ranks("_torch_dist_cases:fail_on_rank_one", 3,
                         env=dict(os.environ, PYTHONPATH=TESTS), timeout=60,
                         deadline=60, threads=1, workdir=tmp_path)
    assert time.monotonic() - t < 30


def test_population_sharding_layout():
    class M:
        size, rank = 4, 0
    for n, q in ((10, 1), (9, 1), (200, 32), (256, 32), (101, 2)):
        rows = []
        for r in range(4):
            M.rank = r
            sh = mapper.population_sharding(M, n, q)
            assert sh.n_loc % q == 0 and sh.n_pad >= n
            rows += list(range(sh.start, sh.stop))
        assert rows == list(range(n))                 # pads at the end


def test_pad_to_multiple_and_unsharded_tpu_map():
    g = torch.arange(10.0).reshape(5, 2)
    p, n = mapper.pad_to_multiple((g, g[:, 0]), 4, fill=-1)
    assert n == 5 and p[0].shape == (8, 2) and (p[1][5:] == -1).all()
    with pytest.raises(ValueError, match="multiple"):
        mapper.pad_to_multiple(g, 0)
    with pytest.raises(ValueError, match="inconsistent"):
        mapper.pad_to_multiple((g, g[:3]), 2)
    with pytest.raises(TypeError):
        mapper.tpu_map(lambda x: x)
    f = lambda x: (x * x).sum()                        # noqa: E731
    want = (g * g).sum(1)
    assert torch.equal(mapper.tpu_map(f, g), want)
    assert torch.equal(mapper.tpu_map(f, g, pad=4), want)


def test_other_axis_names_and_device_ids_are_refused():
    """The port's meshes have one axis: a JAX axis name other than the
    mesh's is refused, not ignored; so is ``local_device_ids`` (a rank
    drives one device)."""
    from deap_tpu_torch.ops import generation_sharded as GS

    class M:
        size, rank, axis_name = 2, 0, "pop"
    pop = C.mk_population(64)
    calls = (
        lambda: mapper.population_sharding(M, 64, 2, axis_name="island"),
        lambda: mapper.shard_population(pop, M, "island"),
        lambda: mapper.tpu_map(lambda x: x.sum(), pop.genome, mesh=M,
                               axis_name="island"),
        lambda: multihost.distribute_population(pop, M, axis_name="island"),
        lambda: thv.hypervolume_sharded(torch.zeros((8, 3)), [1.0] * 3, M,
                                        axis="island"),
        lambda: GS.fused_generation_sharded(
            None, None, pop.genome, pop.genome[:, :1], mesh=M,
            axis="island", dim=C.GEN_DIM, cxpb=0.5, mutpb=0.2))
    for call in calls:
        with pytest.raises(ValueError, match="one axis is 'pop'"):
            call()
    assert mapper.population_sharding(M, 64, 2, axis_name="pop").n_loc == 32
    with pytest.raises(ValueError, match="local_device_ids"):
        multihost.initialize_cluster(local_device_ids=[0])


@pytest.mark.parametrize("R", RANKS)
def test_tpu_map_padding_matches_jax(ranks, R):
    import jax
    import jax.numpy as jnp
    from deap_tpu.parallel import tpu_map
    g = C.map_inputs()
    want = np.asarray(tpu_map(lambda x: jnp.sum(x * x), jnp.asarray(g),
                              mesh=_jmesh(R)))
    for o in ranks[R]:
        assert _same(o["map"], want) and _same(o["map_int"], want)
        if C.MAP_N % R:
            assert "do not divide" in o["map_strict"]
        else:
            assert o["map_strict"] == "ran"
    del jax


# ---------------------------------------------------------------------------
# the row-range draw
# ---------------------------------------------------------------------------


def test_row_range_is_the_slice_of_the_whole_draw():
    import jax
    k = trandom.PRNGKey(11, device="cpu")
    jk = jax.random.PRNGKey(11)
    whole = trandom.uniform(k, (40, 7))
    assert _same(whole, jax.random.uniform(jk, (40, 7)))
    for a, b in ((0, 8), (13, 40), (16, 32)):
        with trandom.row_range((40, a, b)):
            assert torch.equal(trandom.uniform(k, (b - a, 7)), whole[a:b])
            assert torch.equal(trandom.bits(k, (b - a,)),
                               trandom.bits(k, (40,))[a:b])
        with trandom.row_range((40, a, b)):
            assert torch.equal(trandom.split(k, b - a),
                               trandom.split(k, 40)[a:b])
        full = trandom.randint(k, (40, 3), 0, 17)
        with trandom.row_range((40, a, b)):
            assert torch.equal(trandom.randint(k, (b - a, 3), 0, 17),
                               full[a:b])
    kr = trandom.PRNGKey(4, impl="rbg", device="cpu")
    full = trandom.bits(kr, (33, 3))
    with trandom.row_range((33, 9, 30)):
        assert torch.equal(trandom.bits(kr, (21, 3)), full[9:30])
    # small draws (key splits) pass through; refusals
    with trandom.row_range((40, 8, 24)):
        assert torch.equal(trandom.split(k), trandom.split(k, 2))
    with pytest.raises(ValueError, match="at least"):
        with trandom.row_range((40, 0, 4)):
            pass
    with pytest.raises(ValueError, match="two row_range"):
        with trandom.row_range((40, 0, 16), (80, 16, 32)):
            pass


@pytest.mark.parametrize("R", RANKS)
def test_row_range_draw_on_ranks(ranks, R):
    import jax
    want = jax.random.normal(jax.random.PRNGKey(7), (48, 3))
    for o in ranks[R]:
        assert _same(o["row_range"], want)


# ---------------------------------------------------------------------------
# the sharded megakernel generation and engine
# ---------------------------------------------------------------------------


def _jax_mk_toolbox(mesh=None):
    from deap_tpu import base, benchmarks
    from deap_tpu.ops import crossover, mutation, selection
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.3,
                indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    if mesh is not None:
        tb.generation_mesh = mesh
    return tb


@pytest.mark.parametrize("R", RANKS)
def test_fused_generation_sharded(ranks, R):
    """Both gathers at ``row_base0 = rank * n_loc`` equal the
    single-device generation (the port's) and, at R > 1, JAX's sharded
    generation on an R-device mesh."""
    g, w = C.gen_inputs()
    k_sel, k_var = trandom.split(trandom.PRNGKey(3, device="cpu"), 2)
    want = TG.fused_generation(k_sel, k_var, torch.from_numpy(g),
                               torch.from_numpy(w), dim=C.GEN_DIM,
                               gather="host", **C.KNOBS)
    if R > 1:
        import jax
        import jax.numpy as jnp
        from deap_tpu.ops.generation_sharded import fused_generation_sharded
        jk = jax.random.split(jax.random.PRNGKey(3), 2)
        jnew, jidx = fused_generation_sharded(
            jk[0], jk[1], jnp.asarray(g), jnp.asarray(w), mesh=_jmesh(R),
            dim=C.GEN_DIM, **C.KNOBS)
        assert _same(want[0], jnew) and _same(want[1], jidx)
    for o in ranks[R]:
        for gather in ("dma", "host"):
            new, widx = o[f"gen_{gather}"]
            assert _same(new, want[0]), gather
            assert _same(widx, want[1]), gather


@pytest.mark.parametrize("R", (2, 4))
def test_fused_ea_step_sharded_live_and_pad_match_jax(ranks, R):
    """At live < n (a padded population, and a live-prefix mask) the
    step equals JAX's ``fused_ea_step_sharded`` on an R-device mesh."""
    import jax
    import jax.numpy as jnp
    from deap_tpu import base
    from deap_tpu.ops.generation_sharded import fused_ea_step_sharded
    g, w = C.gen_inputs()
    tb = _jax_mk_toolbox(_jmesh(R))
    key = jax.random.PRNGKey(4)
    gp = np.resize(g, (C.PAD_N, C.GEN_DIM))
    pop = base.Population(jnp.asarray(gp), base.Fitness(
        values=jnp.asarray(-np.resize(w, (C.PAD_N, 1))),
        valid=jnp.ones((C.PAD_N,), bool), weights=(-1.0,)))
    _, new = fused_ea_step_sharded(key, pop, tb, 0.9, 0.5)
    pop = base.Population(jnp.asarray(g), base.Fitness(
        values=jnp.asarray(-w), valid=jnp.ones((C.GEN_N,), bool),
        weights=(-1.0,)))
    _, new_live = fused_ea_step_sharded(
        key, pop, tb, 0.9, 0.5, live=jnp.arange(C.GEN_N) < C.PAD_N)
    for o in ranks[R]:
        assert _same(o["step_pad"], new.genome)
        assert _same(o["step_live"], new_live.genome)


@pytest.mark.parametrize("R", RANKS)
def test_sharded_nsga2_head_equals_one_device(ranks, R):
    """The megakernel engine's NSGA-II head on a sharded population
    (``sel_nsga2_sharded`` registered with the mesh, K1 at each rank's
    ``row_base0``) equals the single-device head, directly and through
    ``ea_ask``'s routing."""
    from deap_tpu_torch.ops import emo
    tb = C.mk_toolbox()
    tb.register("select", emo.sel_nsga2)
    _, want = TG.fused_nsga2_step(trandom.PRNGKey(6, device="cpu"),
                                  C.mo_population(), tb, 0.9, 0.5)
    for o in ranks[R]:
        assert _same(o["nsga2_head"], want.genome)
        assert _same(o["nsga2_head_ask"], want.genome)


@pytest.mark.parametrize("R", RANKS)
def test_megakernel_sharded_engine_equals_one_device(ranks, R):
    tb = C.mk_toolbox()
    from deap_tpu_torch.utils.support import Statistics
    stats = Statistics(lambda p: p.fitness.values[:, 0])
    stats.register("min", torch.min)
    final, log = talg.ea_simple(trandom.PRNGKey(9, device="cpu"),
                                C.mk_population(C.GEN_N), tb, 0.9, 0.5, 3,
                                stats=stats)
    for o in ranks[R]:
        genome, mins = o["ea_mk"]
        assert _same(genome, final.genome)
        assert mins == log.select("min")


@pytest.mark.parametrize("R", RANKS)
def test_sharded_ea_simple_bit_identical(ranks, R):
    """``tests/test_parallel.py::test_sharded_ea_simple_bit_identical``
    for the port: the xla engine on a sharded population equals the
    single-device run, and JAX's ``ea_simple`` on an R-device mesh."""
    k_run, pop = C.onemax_start()
    from deap_tpu_torch.utils.support import HallOfFame
    hof = HallOfFame(3)
    final, log = talg.ea_simple(k_run, pop, C.onemax_toolbox(), 0.5, 0.2,
                                C.ONEMAX_GEN, stats=C.onemax_stats(),
                                halloffame=hof)
    if R > 1:
        import jax
        import jax.numpy as jnp
        from deap_tpu import algorithms, base
        from deap_tpu.ops import crossover, mutation, selection
        from deap_tpu.parallel import shard_population
        tb = base.Toolbox()
        tb.register("evaluate", lambda g: (jnp.sum(g),))
        tb.register("mate", crossover.cx_two_point)
        tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
        tb.register("select", selection.sel_tournament, tournsize=3)
        k_init, jk_run = jax.random.split(jax.random.PRNGKey(2))
        g = jax.random.bernoulli(k_init, 0.5, (C.ONEMAX_N, C.ONEMAX_BITS)
                                 ).astype(jnp.float32)
        jpop = shard_population(base.Population(g, base.Fitness.empty(
            C.ONEMAX_N, (1.0,))), _jmesh(R))
        jout, _ = algorithms.ea_simple(jk_run, jpop, tb, 0.5, 0.2,
                                       ngen=C.ONEMAX_GEN)
        assert _same(final.genome, jout.genome)
        assert _same(final.fitness.values, jout.fitness.values)
    for o in ranks[R]:
        genome, values, best, nevals, hof_genome = o["ea_xla"]
        assert _same(genome, final.genome)
        assert _same(values, final.fitness.values)
        assert best == log.select("max")
        assert nevals == log.select("nevals")
        assert _same(hof_genome, hof.state.genome)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("kind", ("per-row", "rowwise"))
def test_sharded_xla_loop_with_per_row_operators(ranks, R, kind):
    """Operators with no batched form on a sharded population: each row's
    ``(dim,)`` draws are the size of a rank's pairs (R = 2) or rows
    (R = 4, and its children in ``ea_mu_plus_lambda``), and still the
    runs equal the single-device ones (and the per-row ``ea_simple`` JAX's
    on an R-device mesh)."""
    k_run, pop = C.row_op_start(kind)
    final, log = talg.ea_simple(k_run, pop, C.row_op_toolbox(kind), 0.6,
                                0.4, C.ROW_OP_GEN, stats=C.onemax_stats())
    if R > 1 and kind == "per-row":
        import jax
        import jax.numpy as jnp
        from deap_tpu import algorithms, base
        from deap_tpu.ops import crossover, mutation, selection
        from deap_tpu.parallel import shard_population
        tb = base.Toolbox()
        tb.register("evaluate", lambda g: (jnp.sum(g),))
        tb.register("mate", lambda k, a, b: crossover.cx_two_point(k, a, b))
        tb.register("mutate",
                    lambda k, g: mutation.mut_flip_bit(k, g, indpb=0.2))
        tb.register("select", selection.sel_tournament, tournsize=3)
        k_init, jk_run = jax.random.split(jax.random.PRNGKey(13))
        g = jax.random.bernoulli(k_init, 0.5, (C.ROW_OP_N, C.ROW_OP_DIM)
                                 ).astype(jnp.float32)
        jpop = shard_population(base.Population(g, base.Fitness.empty(
            C.ROW_OP_N, (1.0,))), _jmesh(R))
        jout, _ = algorithms.ea_simple(jk_run, jpop, tb, 0.6, 0.4,
                                       ngen=C.ROW_OP_GEN)
        assert _same(final.genome, jout.genome)
    mu_final, mu_log = talg.ea_mu_plus_lambda(
        k_run, pop.take(torch.arange(C.ROW_OP_N // 2)),
        C.row_op_toolbox(kind), C.ROW_OP_N // 2, C.ROW_OP_N, 0.5, 0.3,
        C.ROW_OP_GEN, stats=C.onemax_stats())
    for o in ranks[R]:
        genome, values, best = o[("row_op", kind)]
        assert _same(genome, final.genome)
        assert _same(values, final.fitness.values)
        assert best == log.select("max")
        genome, best = o[("row_op_mu", kind)]
        assert _same(genome, mu_final.genome)
        assert best == mu_log.select("max")


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("plus", (True, False), ids=("plus", "comma"))
def test_sharded_mu_lambda_loops(ranks, R, plus):
    """``ea_mu_plus_lambda`` / ``ea_mu_comma_lambda`` on a sharded
    population (each rank its rows of the children) equal the
    single-device loops, which equal JAX's."""
    import jax
    import jax.numpy as jnp
    from deap_tpu import algorithms, base
    from deap_tpu.ops import crossover, mutation, selection
    k_run, pop = C.onemax_start()
    loop = talg.ea_mu_plus_lambda if plus else talg.ea_mu_comma_lambda
    final, log = loop(k_run, pop.take(torch.arange(C.MU_N)),
                      C.onemax_toolbox(), C.MU_N, C.LAMBDA_N, 0.5, 0.3,
                      C.MU_GEN, stats=C.onemax_stats())
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (jnp.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    k_init, jk_run = jax.random.split(jax.random.PRNGKey(2))
    g = jax.random.bernoulli(k_init, 0.5, (C.ONEMAX_N, C.ONEMAX_BITS)
                             ).astype(jnp.float32)[:C.MU_N]
    jloop = (algorithms.ea_mu_plus_lambda if plus
             else algorithms.ea_mu_comma_lambda)
    jout, _ = jloop(jk_run, base.Population(g, base.Fitness.empty(
        C.MU_N, (1.0,))), tb, C.MU_N, C.LAMBDA_N, 0.5, 0.3, C.MU_GEN)
    assert _same(final.genome, jout.genome)
    for o in ranks[R]:
        genome, values, best, nevals = o[("mu_lambda", plus)]
        assert _same(genome, final.genome)
        assert _same(values, final.fitness.values)
        assert best == log.select("max")
        assert nevals == log.select("nevals")


def test_sharded_xla_loop_refuses_tiny_shards_and_odd_layouts():
    sh = mapper.RowSharding(n=40, n_loc=10, size=4, rank=1)
    with pytest.raises(ValueError, match="at least"):
        talg._row_windows(sh)
    sh = mapper.RowSharding(n=99, n_loc=33, size=3, rank=1)
    with pytest.raises(ValueError, match="even row layout"):
        talg._row_windows(sh)


# ---------------------------------------------------------------------------
# islands
# ---------------------------------------------------------------------------


def _jax_islands(R, mig):
    import jax
    import jax.numpy as jnp
    from deap_tpu import base
    from deap_tpu.ops import crossover, mutation, selection
    from deap_tpu.parallel import ea_simple_islands
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (jnp.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(5))
    g = jax.random.bernoulli(k_init, 0.5, (C.ISL, C.ISL_POP, C.ISL_BITS)
                             ).astype(jnp.float32)
    pops = base.Population(g, base.Fitness(
        values=jnp.zeros((C.ISL, C.ISL_POP, 1)),
        valid=jnp.zeros((C.ISL, C.ISL_POP), bool), weights=(1.0,)))
    return ea_simple_islands(k_run, pops, tb, 0.6, 0.3, C.ISL_GEN,
                             mig_freq=2, mig_k=3, migarray=mig,
                             mesh=_jmesh(R, "island"))


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("mig", C.MIGARRAYS, ids=("ring", "map"))
def test_islands_cross_rank_migration(ranks, R, mig):
    from deap_tpu_torch.parallel import ea_simple_islands
    k_run, pops = C.islands_start()
    local, recs = ea_simple_islands(k_run, pops, C.onemax_toolbox(), 0.6,
                                    0.3, C.ISL_GEN, mig_freq=2, mig_k=3,
                                    migarray=mig)
    if R > 1:
        jout, jrecs = _jax_islands(R, mig)
        assert _same(local.genome, jout.genome)
        assert _same(local.fitness.values, jout.fitness.values)
        assert np.array_equal(_np(recs["nevals"]), np.asarray(
            jrecs["nevals"]))
    for o in ranks[R]:
        genome, values, nevals = o[("islands", mig)]
        assert _same(genome, local.genome)
        assert _same(values, local.fitness.values)
        assert torch.equal(nevals, recs["nevals"])


# ---------------------------------------------------------------------------
# hypervolume_sharded and K5's prefix range
# ---------------------------------------------------------------------------


def _ulp_gap(a, b):
    a = np.float32(a).view(np.int32).astype(np.int64)
    b = np.float32(b).view(np.int32).astype(np.int64)
    return abs(int(a) - int(b))


def _jax_hv_sharded_f32(pts, R, block=128):
    """The body of JAX's ``hypervolume_sharded`` at ``d == 3`` in float32,
    one device at a time (each device's slab scan jitted), the partials
    added in device order.  On jax 0.9.0 the function itself does not
    trace: its scan's carry starts unvarying and comes back varying over
    the mesh axis (``deap_tpu/ops/hypervolume.py:282``)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from deap_tpu.ops.hypervolume import _hv3d_prep, _prefix_areas
    n, d = pts.shape
    ref = jnp.ones((d,), jnp.float32)
    n_loc = -(-n // R)
    n_pad = n_loc * R
    blk = min(block, n_loc)
    nb_loc = -(-n_loc // blk)
    p_full = jnp.minimum(jnp.concatenate(
        [jnp.asarray(pts), jnp.broadcast_to(ref, (n_pad - n, d))], 0), ref)

    @jax.jit
    def part(base):
        _, ys, zr, dz, width = _hv3d_prep(p_full, ref)
        dz_pad = jnp.concatenate(
            [dz, jnp.zeros((R * nb_loc * blk - n_pad,), dz.dtype)])

        def slab(acc, b):
            k0 = base + b * blk
            a = _prefix_areas(ys, zr, width, ref[1], k0, blk)
            return acc + jnp.sum(
                a * lax.dynamic_slice(dz_pad, (k0,), (blk,))), None
        acc, _ = lax.scan(slab, jnp.zeros((), jnp.float32),
                          jnp.arange(nb_loc, dtype=jnp.int32))
        return acc

    total = np.float32(0)
    for dv in range(R):
        total = np.float32(total + np.float32(part(dv * nb_loc * blk)))
    return float(total)


@pytest.mark.parametrize("R", RANKS)
def test_hypervolume_sharded(ranks, R):
    from deap_tpu.ops import hv as jhv
    p3, p2 = C.hv_inputs()
    truth3 = jhv.hypervolume(p3, np.ones(3))
    truth2 = jhv.hypervolume(p2, np.ones(2))
    j32 = _jax_hv_sharded_f32(p3.astype(np.float32), R)
    vals = {o["hv3_f64"].item() for o in ranks[R]}
    assert len(vals) == 1                          # equal on every rank
    for o in ranks[R]:
        assert o["hv3_f64"].dtype == torch.float64
        assert o["hv3_f64"].item() == pytest.approx(truth3, rel=1e-11)
        assert o["hv2_f64"].item() == pytest.approx(truth2, rel=1e-12)
        assert o["hv3_f32"].item() == pytest.approx(truth3, rel=1e-5)
        assert _ulp_gap(o["hv3_f32"].item(), j32) <= HV32_ULP


def test_slab_volumes_split_ranges_add_up_bitwise():
    """The plain K5 version over prefix ranges that start on slab
    boundaries gives the whole sweep's slabs, bit for bit, and their
    in-order sum is the whole hypervolume."""
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.float64):
        pts = torch.from_numpy(rng.random((777, 3))).to(dt)
        ref = [1.0, 1.0, 1.0]
        whole = thv._slab_volumes(pts, ref, 128)
        cuts = (0, 256, 384, 640, 777)
        parts = torch.cat([thv._slab_volumes(pts, ref, 128, a, b - a)
                           for a, b in zip(cuts, cuts[1:])])
        assert torch.equal(whole, parts)
        acc = parts.new_zeros(())
        for p in parts.unbind():
            acc = acc + p
        assert torch.equal(acc, thv.hypervolume_3d(pts, ref, 128))
        # a range that ends inside a slab leaves the rest to the next one
        a = thv._slab_volumes(pts, ref, 128, 0, 200)
        b = thv._slab_volumes(pts, ref, 128, 200, 577)
        total = (a.sum() + b.sum()).item()
        assert total == pytest.approx(whole.sum().item(), rel=1e-5)


# ---------------------------------------------------------------------------
# the sharded checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", (1, 4))
def test_sharded_checkpoint_restores_onto_another_rank_count(ranks, R):
    want = C.ckpt_population()
    for r, o in enumerate(ranks[R]):
        key, pop, gen, shape, sharded = o["ckpt"]
        assert torch.equal(key, trandom.PRNGKey(5, device="cpu"))
        assert torch.equal(pop.genome, want.genome)
        assert torch.equal(pop.fitness.values, want.fitness.values)
        assert torch.equal(pop.fitness.valid, want.fitness.valid)
        assert pop.fitness.weights == (1.0, -1.0)
        assert gen == 7 and sharded
        assert shape == (C.CKPT_N // R, 5)


def test_sharded_checkpoint_refusals(tmp_path):
    pop = C.ckpt_population()
    state = {"key": trandom.PRNGKey(3, device="cpu"), "population": pop}
    d = tmp_path / "ck"
    tck.save_sharded_checkpoint(d, state)
    tck.save_sharded_checkpoint(d, state)         # a second version
    assert (d / "COMMIT").read_text() == "v1 1"
    assert sorted(p.name for p in d.iterdir()) == ["COMMIT", "v1"]
    back = tck.load_sharded_checkpoint(d, state)
    assert torch.equal(back["population"].genome, pop.genome)
    (d / "COMMIT").write_text("v1 2")
    with pytest.raises(ValueError, match="2 writer process"):
        tck.load_sharded_checkpoint(d, state)
    (d / "COMMIT").write_text("v1 garbage")
    with pytest.raises(ValueError, match="corrupt COMMIT marker"):
        tck.load_sharded_checkpoint(d, state)
    (d / "COMMIT").unlink()
    with pytest.raises(FileNotFoundError, match="no COMMIT marker"):
        tck.load_sharded_checkpoint(d, state)
    # a sibling directory that merely starts with 'v' survives a save
    (d / "vault").mkdir()
    tck.save_sharded_checkpoint(d, state)
    assert (d / "vault").is_dir() and (d / "COMMIT").read_text() == "v2 1"
