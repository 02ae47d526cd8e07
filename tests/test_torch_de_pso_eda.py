"""The port's DE, PSO and EDA against the jitted JAX functions on the CPU.

Inputs are made with numpy from a seed and the keys are the same on both
sides.  Held bit for bit: DE's donor indices (one batched
``random.permutation`` of ``n - 1`` a row, under threefry and rbg
keys), its trial genomes and replacements in all four variants, PSO's
positions, speeds and bests under both update rules, the multiswarm step
jitted and op by op (with a forced exclusion and a forced
anti-convergence), EMNA's samples and centroid, PBIL's probability
vector and key.  Float values where XLA vectorizes a reduction whose
order the port does not reproduce are held within a bound named per
case, in float32 units in the last place: the 20-gene sphere inside the
DE step (``DE_ULP_BOUND``) and EMNA's sigma (``EMNA_SIGMA_ULP``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, benchmarks as jbench
from deap_tpu import de as jde, eda as jeda, pso as jpso
from deap_tpu.algorithms import ea_generate_update as jegu
from deap_tpu.utils.support import Statistics as JStats
from deap_tpu_torch import base as tbase, benchmarks as tbench, interop
from deap_tpu_torch import de as tde, eda as teda, pso as tpso
from deap_tpu_torch import random as tr
from deap_tpu_torch._xla_math import row_dot
from deap_tpu_torch.algorithms import ea_generate_update as tegu
from deap_tpu_torch.ops._dispatch import batched_op
from deap_tpu_torch.utils.support import Statistics as TStats

torch.set_num_threads(1)

# the sphere inside the jitted DE step at 20 genes: XLA's vectorized
# 4-lane reduction (measured gap on these inputs)
DE_ULP_BOUND = {20: 2}
EMNA_SIGMA_ULP = 2


def _sphere(x):
    """XLA's form of ``benchmarks.sphere`` inside a jitted step: products
    fused into the sum up to 32 genes."""
    return row_dot(x, x, fused=x.shape[-1] <= 32),


batched_op(_sphere, _sphere)


def _neg_sphere(x):
    return -row_dot(x, x, fused=True),


def _neg_sphere_op_by_op(x):
    return -row_dot(x, x, fused=False),


batched_op(_neg_sphere, _neg_sphere)
batched_op(_neg_sphere_op_by_op, _neg_sphere_op_by_op)


def _jneg_sphere(x):
    return -jnp.sum(x * x),


def _tk(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


def _words(impl, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, 4 if impl == "rbg" else 2).astype(np.uint32)


def _jkey(words, impl):
    if impl == "rbg":
        return jax.random.wrap_key_data(words, impl="rbg")
    return jnp.asarray(words)


def _same(a, b):
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(b.numpy() if torch.is_tensor(b) else np.asarray(b))
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _ulps(a, b) -> int:
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64)
            for v in (a, b))
    a, b = (np.where(v < 0, -(v & 0x7FFFFFFF), v) for v in (a, b))
    return int(np.abs(a - b).max()) if a.size else 0


def _fields_equal(want, got):
    return {f.name: _same(getattr(want, f.name), getattr(got, f.name))
            for f in dataclasses.fields(got)}


def _to_torch(state, cls):
    return cls(**{f.name: torch.from_numpy(np.array(getattr(state, f.name)))
                  for f in dataclasses.fields(cls)})


# -- DE -----------------------------------------------------------------------

@pytest.mark.parametrize("n,impl", [(300, "threefry2x32"), (1700, "rbg")])
def test_donor_indices_against_jax(n, impl):
    """One sort round below 1625 rows, two from there."""
    words = _words(impl, n)
    want = jax.jit(lambda k: jde._distinct_indices(k, n, 5),
                   )(_jkey(words, impl))
    got = tde._distinct_indices(_tk(words), n, 5)
    assert _same(want, got.to(torch.int32))
    rows = np.arange(n)[:, None]
    assert not (got.numpy() == rows).any()


def test_donor_indices_chunked(monkeypatch):
    words = _words("threefry2x32", 9)
    want = tde._distinct_indices(_tk(words), 300, 3)
    monkeypatch.setattr(tde, "DONOR_CHUNK_ELEMS", 1000)
    assert torch.equal(tde._distinct_indices(_tk(words), 300, 3), want)


def _de_inputs(pop, dim, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-3, 3, (pop, dim)).astype(np.float32)
    vals = (g.astype(np.float64) ** 2).sum(1, keepdims=True).astype(
        np.float32)
    valid = rng.uniform(size=pop) < 0.9
    return g, vals, valid


DE_STEPS = [("rand/1/bin", 10, 1.0), ("rand/1/bin", 20, 0.6),
            ("best/1/bin", 5, 0.4), ("best/1/bin", 40, 0.5),
            ("rand/2/bin", 40, 0.5), ("rand/2/bin", 20, 0.6),
            ("best/2/bin", 10, 1.0), ("best/2/bin", 5, 0.4)]


@pytest.mark.parametrize("variant,dim,f,impl", [
    *(c + ("threefry2x32",) for c in DE_STEPS),
    *(c + ("rbg",) for c in DE_STEPS[1::2])])
def test_de_step_against_jax(variant, dim, f, impl):
    g, vals, valid = _de_inputs(64, dim, dim)
    words = _words(impl, 5)
    jpop = jbase.Population(jnp.asarray(g), jbase.Fitness(
        jnp.asarray(vals), jnp.asarray(valid), (-1.0,)))
    want = jax.jit(lambda k, p: jde.de_step(
        k, p, jbench.sphere, cr=0.25, f=f, variant=variant))(
        _jkey(words, impl), jpop)
    tpop = tbase.Population(torch.from_numpy(g), tbase.Fitness(
        torch.from_numpy(vals), torch.from_numpy(valid), (-1.0,)))
    got = tde.de_step(_tk(words), tpop, _sphere, cr=0.25, f=f,
                      variant=variant)
    assert _same(want.genome, got.genome)
    assert _same(want.fitness.valid, got.fitness.valid)
    assert _ulps(want.fitness.values, got.fitness.values) <= \
        DE_ULP_BOUND.get(dim, 0)


def test_de_step_op_by_op_form():
    """``fused=False`` is the JAX step called op by op (not jitted)."""
    g, vals, valid = _de_inputs(16, 6, 3)
    key = jax.random.PRNGKey(4)
    jpop = jbase.Population(jnp.asarray(g), jbase.Fitness(
        jnp.asarray(vals), jnp.asarray(valid), (-1.0,)))
    want = jde.de_step(key, jpop, jbench.sphere, cr=0.6, f=0.4)

    def unfused(x):
        return row_dot(x, x, fused=False),
    batched_op(unfused, unfused)
    got = tde.de_step(_tk(key), tbase.Population(
        torch.from_numpy(g), tbase.Fitness(torch.from_numpy(vals),
                                           torch.from_numpy(valid),
                                           (-1.0,))),
        unfused, cr=0.6, f=0.4, fused=False)
    assert _same(want.genome, got.genome)
    assert _same(want.fitness.values, got.fitness.values)


def test_de_step_rejects_small_populations_and_trees():
    pop = tbase.Population(torch.zeros(5, 3), tbase.Fitness.empty(
        5, (-1.0,), device="cpu"))
    with pytest.raises(ValueError, match="at least 6"):
        tde.de_step(tr.PRNGKey(0, device="cpu"), pop, _sphere,
                    variant="rand/2/bin")
    with pytest.raises(TypeError):
        tde.de_step(tr.PRNGKey(0, device="cpu"), tbase.Population(
            {"x": torch.zeros(8, 3)}, pop.fitness), _sphere)


def test_de_loop_against_jax():
    """``de``: the op-by-op initial evaluation, then the scanned
    generations; the logbook's columns and the hall of fame."""
    from deap_tpu.utils.support import HallOfFame as JHof
    from deap_tpu_torch.utils.support import HallOfFame as THof

    def unfused(x):
        return row_dot(x, x, fused=False),
    batched_op(unfused, unfused)
    g, _, _ = _de_inputs(48, 10, 7)
    key = jax.random.PRNGKey(8)
    js, ts = JStats(lambda p: p.fitness.values[:, 0]), \
        TStats(lambda p: p.fitness.values[:, 0])
    js.register("min", jnp.min)
    ts.register("min", torch.min)
    jh, th = JHof(2), THof(2)
    want, jlog = jde.de(key, jbase.Population(jnp.asarray(g),
                        jbase.Fitness.empty(48, (-1.0,))), jbench.sphere,
                        ngen=6, stats=js, halloffame=jh)
    got, tlog = tde.de(_tk(key), tbase.Population(
        torch.from_numpy(g), tbase.Fitness.empty(48, (-1.0,),
                                                 device="cpu")),
        _sphere, ngen=6, stats=ts, halloffame=th,
        evaluate_initial=unfused)
    assert _same(want.genome, got.genome)
    assert _same(want.fitness.values, got.fitness.values)
    assert tlog.header == jlog.header
    assert tlog.select("min") == [float(v) for v in jlog.select("min")]
    assert tlog.select("nevals") == list(jlog.select("nevals"))
    assert _same(jh.state.genome, th.state.genome)


# -- PSO ----------------------------------------------------------------------

PSO_CASES = {
    "canonical, speed limits": ("himmelblau", 2,
                                dict(phi1=2.0, phi2=2.0, smin=-3.0,
                                     smax=3.0)),
    "canonical, smax only": ("sphere", 10, dict(phi1=1.5, phi2=2.5,
                                                smax=1.0)),
    "constriction": ("sphere", 10, dict(constriction=True)),
}


def _pso_fn(name, side):
    if name == "sphere":
        return jbench.sphere if side == "jax" else _sphere
    return getattr(jbench if side == "jax" else tbench, name)


@pytest.mark.parametrize("case", sorted(PSO_CASES))
def test_pso_step_against_jax(case):
    fn, dim, kw = PSO_CASES[case]
    key = jax.random.PRNGKey(13)
    state = jpso.pso_init(key, 40, dim, -6.0, 6.0, -3.0, 3.0)
    tstate = tpso.pso_init(_tk(key), 40, dim, -6.0, 6.0, -3.0, 3.0)
    assert all(_fields_equal(state, tstate).values())
    step = jax.jit(lambda k, s: jpso.pso_step(k, s, _pso_fn(fn, "jax"),
                                              (-1.0,), **kw))
    k = jax.random.PRNGKey(1)
    for _ in range(4):
        k, kk = jax.random.split(k)
        nxt, raw = step(kk, state)
        got, traw = tpso.pso_step(_tk(kk), _to_torch(state, tpso.PSOState),
                                  _pso_fn(fn, "torch"), (-1.0,), **kw)
        assert all(_fields_equal(nxt, got).values()), _fields_equal(nxt, got)
        assert _same(raw, traw)
        state = nxt


def test_pso_loop_against_jax():
    """``pso``: the scanned loop and its logbook (``gen`` and the
    statistics' columns)."""
    key = jax.random.PRNGKey(5)
    state = jpso.pso_init(key, 30, 2, -6.0, 6.0, -3.0, 3.0)
    js, ts = JStats(lambda p: p.fitness.values[:, 0]), \
        TStats(lambda p: p.fitness.values[:, 0])
    js.register("max", jnp.max)
    ts.register("max", torch.max)
    kw = dict(phi1=2.0, phi2=2.0, smin=-3.0, smax=3.0)
    want, jlog = jpso.pso(jax.random.PRNGKey(6), state, jbench.himmelblau,
                          ngen=8, stats=js, **kw)
    got, tlog = tpso.pso(_tk(jax.random.PRNGKey(6)),
                         _to_torch(state, tpso.PSOState), tbench.himmelblau,
                         ngen=8, stats=ts, **kw)
    assert all(_fields_equal(want, got).values())
    assert tlog.header == jlog.header
    assert tlog.select("max") == [float(v) for v in jlog.select("max")]


def _ms_step_jax(fused):
    def step(k, s, rexcl):
        return jpso.multiswarm_step(k, s, _jneg_sphere, (1.0,),
                                    rexcl=rexcl, rcloud=1.0)
    return jax.jit(step, static_argnums=2) if fused else step


@pytest.mark.parametrize("case,fused", [
    ("plain", True), ("exclusion", True), ("anti-convergence", True),
    ("inactive swarm", True), ("exclusion", False),
    ("anti-convergence", False)])
def test_multiswarm_step_against_jax(case, fused):
    """Jitted (``fused=True``) and op by op (``fused=False``), with a
    forced exclusion (two swarms' bests 0.01 apart and tied, neither
    improved: the later is reinitialised) and a forced anti-convergence
    (every swarm at rest on its best: the worst is reinitialised)."""
    key = jax.random.PRNGKey(14)
    active = 4 if case == "inactive swarm" else None
    state = jpso.multiswarm_init(key, 5, 6, 4, 0.0, 10.0, active=active)
    tstate = tpso.multiswarm_init(_tk(key), 5, 6, 4, 0.0, 10.0,
                                  active=active)
    assert all(_fields_equal(state, tstate).values())
    step = _ms_step_jax(fused)
    rexcl = 0.5
    k = jax.random.PRNGKey(2)
    reinit_seen = 0
    for gen in range(2):
        if gen == 1 and case == "exclusion":
            sb = np.array(state.sbest)
            sb[1] = sb[0] + 0.01
            sw = np.array(state.sbest_w)
            sw[:2] = -1e-3
            state = dataclasses.replace(state, sbest=jnp.asarray(sb),
                                        sbest_w=jnp.asarray(sw))
        if gen == 1 and case == "anti-convergence":
            rexcl = 5.0
            sb = np.array(state.sbest)
            pos = np.repeat(sb[:, None], 6, 1) + np.float32(1e-3)
            state = dataclasses.replace(
                state, position=jnp.asarray(pos), pbest=jnp.asarray(pos),
                speed=jnp.zeros_like(state.speed),
                sbest_w=jnp.full((5,), -1e-3, jnp.float32) +
                jnp.arange(5, dtype=jnp.float32) * 1e-4)
        k, kk = jax.random.split(k)
        nxt, sbw = step(kk, state, rexcl)
        got, tsbw = tpso.multiswarm_step(
            _tk(kk), _to_torch(state, tpso.MultiswarmState),
            _neg_sphere if fused else _neg_sphere_op_by_op,
            (1.0,), rexcl=rexcl, rcloud=1.0, fused=fused)
        eq = _fields_equal(nxt, got)
        assert all(eq.values()), eq
        assert _same(sbw, tsbw)
        reinit_seen += int(np.isneginf(np.asarray(nxt.pbest_w)).all(1).sum())
        state = nxt
    if case in ("exclusion", "anti-convergence"):
        assert reinit_seen >= 1


def test_uniform_with_device_bounds_against_jax():
    """``random.uniform`` with tensor bounds: ``span`` in float32, then
    the FMA and the clamp, as jax computes traced bounds."""
    key = jax.random.PRNGKey(21)
    for lo, hi in ((-0.7, 0.7), (-93.25, 93.25), (3.0, 3.0), (1.5, 7.25)):
        want = jax.jit(lambda k, a, b: jax.random.uniform(
            k, (4, 50), minval=a, maxval=b))(key, jnp.float32(lo),
                                             jnp.float32(hi))
        got = tr.uniform(_tk(key), (4, 50), minval=torch.tensor(lo),
                         maxval=torch.tensor(hi))
        assert _same(want, got)
        got = tr.uniform(_tk(key), (4, 50), minval=lo,
                         maxval=torch.tensor(hi))
        assert _same(want, got)


# -- EDA ----------------------------------------------------------------------

@pytest.mark.parametrize("dim,lam,mu", [(5, 100, 25), (7, 90, 45),
                                        (30, 64, 16), (100, 512, 256)])
def test_emna_against_jax(dim, lam, mu):
    js = jeda.EMNA([5.0] * dim, 5.0, mu, lam)
    ts = teda.EMNA([5.0] * dim, 5.0, mu, lam, device="cpu")
    rng = np.random.default_rng(dim)
    c = rng.uniform(-1, 1, dim).astype(np.float32)
    state = jeda.EMNAState(centroid=jnp.asarray(c), sigma=jnp.float32(0.37))
    tstate = teda.EMNAState(torch.from_numpy(c), torch.tensor(0.37))
    key = jax.random.PRNGKey(dim)
    g = np.asarray(jax.jit(js.generate)(state, key))
    assert _same(g, ts.generate(tstate, _tk(key)))
    vals = (g.astype(np.float64) ** 2).sum(1, keepdims=True).astype(
        np.float32)
    vals[::7] = vals[3]                          # ties: the stable order
    pop = jbase.Population(jnp.asarray(g), jbase.Fitness(
        jnp.asarray(vals), jnp.ones(lam, bool), (-1.0,)))
    want = jax.jit(js.update)(state, pop)
    got = ts.update(tstate, tbase.Population(torch.from_numpy(g),
                    tbase.Fitness(torch.from_numpy(vals),
                                  torch.ones(lam, dtype=torch.bool),
                                  (-1.0,))))
    assert _same(want.centroid, got.centroid)
    assert _ulps(want.sigma, got.sigma) <= EMNA_SIGMA_ULP


@pytest.mark.parametrize("nd,lam", [(50, 20), (100, 64)])
def test_pbil_against_jax(nd, lam):
    js = jeda.PBIL(nd, 0.3, 0.1, 0.05, lam, seed=19)
    ts = teda.PBIL(nd, 0.3, 0.1, 0.05, lam, seed=19, device="cpu")
    state = js.init()
    tstate = ts.init()
    assert _same(state.prob_vector, tstate.prob_vector)
    assert _same(state.key, interop.key_to_numpy(tstate.key))
    rng = np.random.default_rng(nd)
    pv = rng.uniform(0, 1, nd).astype(np.float32)
    state = jeda.PBILState(prob_vector=jnp.asarray(pv), key=state.key)
    tstate = teda.PBILState(torch.from_numpy(pv), _tk(state.key))
    for gen in range(3):
        key = jax.random.PRNGKey(gen)
        g = np.asarray(jax.jit(js.generate)(state, key))
        assert _same(g, ts.generate(tstate, _tk(key)))
        vals = g.sum(1, keepdims=True)
        pop = jbase.Population(jnp.asarray(g), jbase.Fitness(
            jnp.asarray(vals), jnp.ones(lam, bool), (1.0,)))
        state = jax.jit(js.update)(state, pop)
        tstate = ts.update(tstate, tbase.Population(
            torch.from_numpy(g), tbase.Fitness(
                torch.from_numpy(vals), torch.ones(lam, dtype=torch.bool),
                (1.0,))))
        assert _same(state.prob_vector, tstate.prob_vector)
        assert _same(state.key, interop.key_to_numpy(tstate.key))


def test_eda_through_ea_generate_update_against_jax():
    """PBIL's whole ask/tell loop bit for bit; EMNA's first generation
    (its sigma is within an ulp, and the next samples follow it)."""
    js = jeda.PBIL(30, 0.3, 0.1, 0.05, 16, seed=3)
    ts = teda.PBIL(30, 0.3, 0.1, 0.05, 16, seed=3, device="cpu")
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    jtb.register("evaluate", lambda g: (jnp.sum(g),))
    ttb.register("evaluate", lambda g: (g.sum(),))
    for tb, s in ((jtb, js), (ttb, ts)):
        tb.register("generate", s.generate)
        tb.register("update", s.update)
    want = jegu(jax.random.PRNGKey(4), jtb, js.init(), ngen=12,
                weights=(1.0,))
    got = tegu(_tk(jax.random.PRNGKey(4)), ttb, ts.init(), ngen=12,
               weights=(1.0,))
    assert _same(want[0].genome, got[0].genome)
    assert _same(want[1].prob_vector, got[1].prob_vector)
    js = jeda.EMNA([5.0] * 5, 5.0, 25, 100)
    ts = teda.EMNA([5.0] * 5, 5.0, 25, 100, device="cpu")
    jtb.register("evaluate", jbench.sphere)
    ttb.register("evaluate", _sphere)
    for tb, s in ((jtb, js), (ttb, ts)):
        tb.register("generate", s.generate)
        tb.register("update", s.update)
    want = jegu(jax.random.PRNGKey(5), jtb, js.init(), ngen=1)
    got = tegu(_tk(jax.random.PRNGKey(5)), ttb, ts.init(), ngen=1)
    assert _same(want[0].genome, got[0].genome)
    assert _same(want[0].fitness.values, got[0].fitness.values)
    assert _same(want[1].centroid, got[1].centroid)
    assert _ulps(want[1].sigma, got[1].sigma) <= EMNA_SIGMA_ULP


def test_interop_state_converters():
    key = jax.random.PRNGKey(3)
    ps = jpso.pso_init(key, 8, 3, -1.0, 1.0, -0.5, 0.5)
    assert all(_fields_equal(ps, interop.pso_state_to_torch(
        ps, device="cpu")).values())
    ms = jpso.multiswarm_init(key, 3, 4, 2, 0.0, 1.0, active=2)
    assert all(_fields_equal(ms, interop.multiswarm_state_to_torch(
        ms, device="cpu")).values())
    es = jeda.EMNA([1.0, 2.0], 0.5, 2, 4).init()
    assert all(_fields_equal(es, interop.emna_state_to_torch(
        es, device="cpu")).values())
    pb = jeda.PBIL(6, 0.1, 0.1, 0.1, 4, seed=7).init()
    tpb = interop.pbil_state_to_torch(pb, device="cpu")
    assert _same(pb.prob_vector, tpb.prob_vector)
    assert _same(pb.key, interop.key_to_numpy(tpb.key))
    assert tpb.key.dtype == torch.int64


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from deap_tpu_torch import NoCudaDevice
    with pytest.raises(NoCudaDevice):
        teda.EMNA([1.0], 1.0, 1, 2)
    with pytest.raises(NoCudaDevice):
        teda.PBIL(4, 0.1, 0.1, 0.1, 4).init()
