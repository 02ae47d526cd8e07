"""Calls where the port once raised and the JAX package returns a result,
each held against jitted JAX on the same inputs (made from a seed with
numpy):

* ``reevaluate_all`` in ``ea_step`` and ``ea_simple`` (xla engine):
  genome, fitness and ``nevals`` bitwise over three generations; a
  ``live`` mask is refused with ``ValueError``; the megakernel engine
  takes the flag and is unchanged by it;
* the JAX package's per-tree registration of the GP operators
  (``lambda k, t: gp.mut_uniform(k, t, expr, pset)``, as
  ``examples/gp/parity.py`` registers them) through ``ea_simple``: trees
  bitwise, fitness equal (the parity fitness counts rows: exact);
* ``make_population_evaluator(..., block_trees=...)``: accepted,
  ``ValueError`` below 1;
* bfloat16 ``random.normal`` and ``mut_gaussian``: bitwise;
* float32 ``mut_gaussian`` against the program XLA compiles under
  ``jit`` (``sigma * sqrt(2)`` folded into one float32 factor, the add to
  the gene an FMA where a Python ``mu`` is 0): bitwise with Python
  numbers, tensors and per-gene arrays for ``mu`` and ``sigma``, and
  inside the xla engine's generation (``bench.py``'s body and
  ``ea_step``), three generations scanned.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, gp as jgp
from deap_tpu.algorithms import ea_simple as j_ea_simple
from deap_tpu.algorithms import ea_step as j_ea_step
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu.ops import crossover as jcx, mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import base as tbase, gp as tgp, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.algorithms import ea_simple, ea_step
from deap_tpu_torch.algorithms import evaluate_population as t_eval
from deap_tpu_torch.ops import crossover as tcx, mutation as tmut
from deap_tpu_torch.ops import selection as tsel

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

POP, DIM, NGEN = 64, 8, 3
CXPB, MUTPB = 0.6, 0.4


def _bits(x):
    x = np.asarray(x)
    return x.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[x.itemsize])


# ---------------------------------------------------------------------------
# reevaluate_all
# ---------------------------------------------------------------------------


def _ga_toolboxes():
    """The same GA in both packages; the fitness is the largest gene, exact
    in any reduction order, and polynomial mutation is bitwise under
    ``jit`` (``tests/test_torch_sbx_poly.py``), so the trajectories can be
    compared bitwise."""
    jtb = jbase.Toolbox()
    jtb.register("evaluate", lambda g: (jnp.max(g),))
    jtb.register("mate", jcx.cx_two_point)
    jtb.register("mutate", jmut.mut_polynomial_bounded, eta=20.0, low=-1.0,
                 up=1.0, indpb=0.2)
    jtb.register("select", jsel.sel_tournament, tournsize=3)
    ttb = tbase.Toolbox()
    ttb.register("evaluate", lambda g: (torch.max(g),))
    ttb.register("mate", tcx.cx_two_point)
    ttb.register("mutate", tmut.mut_polynomial_bounded, eta=20.0, low=-1.0,
                 up=1.0, indpb=0.2)
    ttb.register("select", tsel.sel_tournament, tournsize=3)
    return jtb, ttb


def _ga_populations(seed=0):
    g = np.random.default_rng(seed).uniform(-1, 1, (POP, DIM)).astype(
        np.float32)
    jpop = jbase.Population(jnp.asarray(g), jbase.Fitness.empty(POP, (1.0,)))
    tpop = tbase.Population(torch.from_numpy(g),
                            tbase.Fitness.empty(POP, (1.0,), device="cpu"))
    return jpop, tpop


def _same_population(jpop, tpop):
    assert np.array_equal(_bits(jpop.genome), _bits(tpop.genome.numpy()))
    assert np.array_equal(_bits(jpop.fitness.values),
                          _bits(tpop.fitness.values.numpy()))
    assert np.array_equal(np.asarray(jpop.fitness.valid),
                          tpop.fitness.valid.numpy())


def test_ea_step_reevaluate_all_matches_jax():
    jtb, ttb = _ga_toolboxes()
    jpop, tpop = _ga_populations()
    jpop, _ = j_eval(jtb, jpop)
    tpop, _ = t_eval(ttb, tpop)
    step = jax.jit(lambda k, p: j_ea_step(k, p, jtb, CXPB, MUTPB,
                                          reevaluate_all=True))
    jkey, tkey = jax.random.PRNGKey(3), tr.PRNGKey(3, device="cpu")
    for _ in range(NGEN):
        jkey, jpop, jn = step(jkey, jpop)
        tkey, tpop, tn = ea_step(tkey, tpop, ttb, CXPB, MUTPB,
                                 reevaluate_all=True)
        assert np.array_equal(np.asarray(jkey), interop.key_to_numpy(tkey))
        _same_population(jpop, tpop)
        assert int(jn) == int(tn) and 0 < int(tn) < POP
    assert tpop.fitness.valid.all()


def test_ea_simple_reevaluate_all_matches_jax():
    jtb, ttb = _ga_toolboxes()
    jpop, tpop = _ga_populations(1)
    jfin, jlog = j_ea_simple(jax.random.PRNGKey(4), jpop, jtb, CXPB, MUTPB,
                             NGEN, reevaluate_all=True)
    tfin, tlog = ea_simple(tr.PRNGKey(4, device="cpu"), tpop, ttb, CXPB,
                           MUTPB, NGEN, reevaluate_all=True)
    _same_population(jfin, tfin)
    assert ([int(n) for n in jlog.select("nevals")]
            == [int(n) for n in tlog.select("nevals")])
    # a deterministic evaluate: the same trajectory as without the flag
    plain, _ = ea_simple(tr.PRNGKey(4, device="cpu"), tpop, ttb, CXPB,
                         MUTPB, NGEN)
    assert torch.equal(plain.genome, tfin.genome)


def test_reevaluate_all_refuses_a_live_mask():
    _, ttb = _ga_toolboxes()
    _, tpop = _ga_populations()
    tpop, _ = t_eval(ttb, tpop)
    live = torch.arange(POP) < POP - 8
    with pytest.raises(ValueError, match="live mask"):
        ea_step(tr.PRNGKey(0, device="cpu"), tpop, ttb, CXPB, MUTPB,
                reevaluate_all=True, live=live)


def test_megakernel_engine_takes_reevaluate_all_unchanged():
    """The megakernel generation evaluates every row already: the flag is
    accepted and the step is the same."""
    from deap_tpu_torch import benchmarks
    tb = tbase.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", tcx.cx_two_point)
    tb.register("mutate", tmut.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3,
                tie_break="rank")
    tb.generation_engine = "megakernel"
    g = torch.from_numpy(np.random.default_rng(2).uniform(
        -5.12, 5.12, (POP, 16)).astype(np.float32))
    pop = tbase.Population(g, tbase.Fitness.empty(POP, (-1.0,),
                                                  device="cpu"))
    pop, _ = t_eval(tb, pop)
    key = tr.PRNGKey(6, device="cpu")
    a = ea_step(key, pop, tb, 0.9, 0.5)
    b = ea_step(key, pop, tb, 0.9, 0.5, reevaluate_all=True)
    assert torch.equal(a[1].genome, b[1].genome)
    assert torch.equal(a[1].fitness.values, b[1].fitness.values)
    assert int(a[2]) == int(b[2])


# ---------------------------------------------------------------------------
# the per-tree GP registration (examples/gp/parity.py)
# ---------------------------------------------------------------------------

GP_POP, CAP, FANIN = 32, 32, 3


def _parity_rows():
    rows = np.array(list(itertools.product([0, 1], repeat=FANIN)),
                    np.float32)
    return rows.T, rows.sum(1) % 2 == 0


def _jax_parity():
    ps = jgp.PrimitiveSet("PARITY", FANIN)
    for name in ("and_", "or_", "xor_", "not_"):
        fn, ar = jgp.bool_ops[name]
        ps.add_primitive(fn, ar, name=name)
    ps.add_terminal(1.0, name="one")
    ps.add_terminal(0.0, name="zero")
    X, target = (jnp.asarray(a) for a in _parity_rows())
    pop_ev = jgp.make_population_evaluator(ps, CAP, backend="xla")
    gen_mut = jgp.make_generator(ps, CAP, "grow")

    def evaluate_all(genome):
        out = pop_ev(*genome, X)
        return jnp.sum((out != 0) == target[None, :], axis=1).astype(
            jnp.float32)[:, None]

    tb = jbase.Toolbox()
    tb.register("evaluate_population", evaluate_all)
    tb.register("mate", lambda k, a, b: jgp.cx_one_point(k, a, b, ps))
    tb.register("mutate", lambda k, t: jgp.mut_uniform(
        k, t, lambda kk: gen_mut(kk, 0, 2), ps))
    tb.register("select", jsel.sel_tournament, tournsize=3)
    return ps, tb


def _torch_parity(leaf_biased=False):
    """The reference example's registration, in the port: lambdas over one
    key and one tree, no ``rowwise_op`` mark on them."""
    ps = tgp.PrimitiveSet("PARITY", FANIN)
    for name in ("and_", "or_", "xor_", "not_"):
        fn, ar = tgp.bool_ops[name]
        ps.add_primitive(fn, ar, name=name)
    ps.add_terminal(1.0, name="one")
    ps.add_terminal(0.0, name="zero")
    X, target = (torch.from_numpy(a) for a in _parity_rows())
    pop_ev = tgp.make_population_evaluator(ps, CAP)
    gen_mut = tgp.make_generator(ps, CAP, "grow")

    def evaluate_all(genome):
        out = pop_ev(*genome, X)
        return ((out != 0) == target[None, :]).sum(1).float()[:, None]

    tb = tbase.Toolbox()
    tb.register("evaluate_population", evaluate_all)
    if leaf_biased:
        tb.register("mate", lambda k, a, b: tgp.cx_one_point_leaf_biased(
            k, a, b, ps, 0.1))
    else:
        tb.register("mate", lambda k, a, b: tgp.cx_one_point(k, a, b, ps))
    tb.register("mutate", lambda k, t: tgp.mut_uniform(
        k, t, lambda kk: gen_mut(kk, 0, 2), ps))
    tb.register("select", tsel.sel_tournament, tournsize=3)
    return ps, tb


@pytest.mark.parametrize("ngen", [1, 3])
def test_per_tree_gp_registration_through_ea_simple_matches_jax(ngen):
    jps, jtb = _jax_parity()
    tps, ttb = _torch_parity()
    jinit = jgp.make_generator(jps, CAP, "half_and_half")
    tinit = tgp.make_generator(tps, CAP, "half_and_half")
    keys = jax.random.split(jax.random.PRNGKey(27), GP_POP)
    jgen = jax.jit(jax.vmap(lambda k: jinit(k, 1, 3)))(keys)
    # the generator's per-tree form, one key a call, as jax.vmap runs it
    tkeys = interop.key_to_torch(keys, device="cpu").reshape(GP_POP, 2)
    per_tree = [tinit(tkeys[i], 1, 3) for i in range(GP_POP)]
    tgen = tuple(torch.stack(x) for x in zip(*per_tree))
    for a, b in zip(jgen, tgen):
        assert np.array_equal(np.asarray(a), b.numpy())
    jpop = jbase.Population(jgen, jbase.Fitness.empty(GP_POP, (1.0,)))
    tpop = tbase.Population(tgen, tbase.Fitness.empty(GP_POP, (1.0,),
                                                      device="cpu"))
    jfin, _ = j_ea_simple(jax.random.PRNGKey(5), jpop, jtb, 0.8, 0.15, ngen)
    tfin, _ = ea_simple(tr.PRNGKey(5, device="cpu"), tpop, ttb, 0.8, 0.15,
                        ngen)
    for a, b in zip(jfin.genome, tfin.genome):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jfin.fitness.values),
                          tfin.fitness.values.numpy())


def test_per_tree_calls_equal_the_rowwise_batch():
    """Each rowwise op called per tree returns row ``i`` of the batched
    call under ``split(key, n)``; the leaf-biased crossover too."""
    ps, tb = _torch_parity()
    gen = tgp.make_generator(ps, CAP, "half_and_half")
    keys = tr.split(tr.PRNGKey(1, device="cpu"), 8)
    a, b = gen(keys, 1, 3), gen(tr.split(keys[0], 8), 1, 3)
    ck = tr.split(tr.PRNGKey(2, device="cpu"), 8)
    gen_mut = tgp.make_generator(ps, CAP, "grow")
    for op, operands in (
            (lambda k, x, y: tgp.cx_one_point(k, x, y, ps), (a, b)),
            (lambda k, x, y: tgp.cx_one_point_leaf_biased(k, x, y, ps),
             (a, b)),
            (lambda k, x: tgp.mut_uniform(
                k, x, lambda kk: gen_mut(kk, 0, 2), ps), (a,))):
        batch = op(ck, *operands)
        for i in range(8):
            row = op(ck[i], *(tuple(t[i] for t in o) for o in operands))
            flat_b = batch if isinstance(batch[0], tuple) else (batch,)
            flat_r = row if isinstance(row[0], tuple) else (row,)
            for tb_, tr_ in zip(flat_b, flat_r):
                for x, y in zip(tb_, tr_):
                    assert y.shape == x.shape[1:]
                    assert torch.equal(x[i], y)


# ---------------------------------------------------------------------------
# block_trees
# ---------------------------------------------------------------------------


def test_population_evaluator_takes_and_checks_block_trees():
    ps, _ = _torch_parity()
    X, _ = _parity_rows()
    gen = tgp.make_generator(ps, CAP, "half_and_half")
    tree = gen(tr.split(tr.PRNGKey(0, device="cpu"), 4), 1, 3)
    want = tgp.make_population_evaluator(ps, CAP)(*tree, torch.from_numpy(X))
    for bt in (1, 8, 32):
        ev = tgp.make_population_evaluator(ps, CAP, block_trees=bt)
        assert torch.equal(ev(*tree, torch.from_numpy(X)), want)
    for bt in (0, -3):
        with pytest.raises(ValueError, match="block_trees"):
            tgp.make_population_evaluator(ps, CAP, block_trees=bt)
        with pytest.raises(ValueError, match="block_trees"):
            jgp.make_population_evaluator(_jax_parity()[0], CAP,
                                          block_trees=bt)


# ---------------------------------------------------------------------------
# bfloat16 normals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (6,)), (3, (7,)), (3, (1001,)),
                                        (11, (64, 33))])
def test_bfloat16_normal_matches_jax(seed, shape):
    want = jax.jit(lambda k: jax.random.normal(k, shape, jnp.bfloat16))(
        jax.random.PRNGKey(seed))
    got = tr.normal(tr.PRNGKey(seed, device="cpu"), shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert np.array_equal(_bits(want), got.view(torch.int16).numpy()
                          .view(np.uint16))


def test_bfloat16_normal_covers_every_uniform_value():
    """bfloat16 uniforms take 128 values; 4096 draws reach all of them,
    so every value the sampler can return is held against jax's."""
    shape = (4096,)
    got = tr.normal(tr.PRNGKey(9, device="cpu"), shape, torch.bfloat16)
    assert len(torch.unique(got)) == 128
    want = jax.jit(lambda k: jax.random.normal(k, shape, jnp.bfloat16))(
        jax.random.PRNGKey(9))
    assert np.array_equal(_bits(want), got.view(torch.int16).numpy()
                          .view(np.uint16))


@pytest.mark.parametrize("mu,sigma,indpb", [(0.0, 1.0, 0.5),
                                            (0.5, 0.3, 0.2),
                                            (-1.25, 2.7, 0.9)])
def test_bfloat16_mut_gaussian_matches_jit(mu, sigma, indpb):
    x = np.random.default_rng(4).normal(size=(64, 33)).astype(np.float32)
    fn = jax.jit(lambda k, v: jmut.mut_gaussian(k, v, mu, sigma, indpb))
    for seed in range(3):
        want = fn(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.bfloat16))
        got = tmut.mut_gaussian(tr.PRNGKey(seed, device="cpu"),
                                torch.from_numpy(x).to(torch.bfloat16), mu,
                                sigma, indpb)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_bits(want), got.view(torch.int16).numpy()
                              .view(np.uint16))


# ---------------------------------------------------------------------------
# float32 mut_gaussian against the jitted program
# ---------------------------------------------------------------------------

MG_POP, MG_DIM, MG_INDPB = 64, 8, 0.2
MG_PER_GENE = np.linspace(0.1, 1.7, MG_DIM).astype(np.float32)


def _mg_genome():
    return np.random.default_rng(5).normal(size=(MG_POP, MG_DIM)).astype(
        np.float32)


def _mg_check(jit_fn, jargs, mu, sigma):
    """Four keys through ``jit_fn(key, genome, *jargs)`` and the port's
    ``mut_gaussian(key, genome, mu, sigma, MG_INDPB)``: bitwise, and some
    genes moved."""
    x = _mg_genome()
    moved = 0
    for seed in range(4):
        want = np.asarray(jit_fn(jax.random.PRNGKey(seed), jnp.asarray(x),
                                 *jargs))
        got = tmut.mut_gaussian(tr.PRNGKey(seed, device="cpu"),
                                torch.from_numpy(x), mu, sigma,
                                MG_INDPB).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(_bits(want), _bits(got))
        moved += int((got != x).sum())
    assert moved > 0


@pytest.mark.parametrize("mu,sigma", [(0.0, 0.3), (0.5, 0.3),
                                      (0.0, 0.013987996), (-1.25, 2.7)])
def test_float32_mut_gaussian_matches_jit_python_scalars(mu, sigma):
    """``sigma`` and ``mu`` as Python numbers: constants of the program.
    0.013987996 is a ``sigma`` where ``float32(float32(sigma) * float32(
    sqrt 2))`` and the product rounded once from double differ; XLA
    folds the former."""
    fn = jax.jit(lambda k, v: jmut.mut_gaussian(k, v, mu, sigma, MG_INDPB))
    _mg_check(fn, (), mu, sigma)


@pytest.mark.parametrize("mu,sigma", [(0.0, 0.3), (0.5, 0.3),
                                      (0.0, MG_PER_GENE),
                                      (MG_PER_GENE - 0.8, 0.3)])
def test_float32_mut_gaussian_matches_jit_tensor_parameters(mu, sigma):
    """``mu`` and ``sigma`` as arrays the program takes as arguments
    (scalars and per-gene rows): a traced ``mu`` of 0 is an add like any
    other, so the gene is ``ind + fma(erf_inv(u), c, mu)``."""
    fn = jax.jit(lambda k, v, m, s: jmut.mut_gaussian(k, v, m, s, MG_INDPB))
    m, s = (np.asarray(a, np.float32) for a in (mu, sigma))
    _mg_check(fn, (jnp.asarray(m), jnp.asarray(s)), torch.from_numpy(m),
              torch.from_numpy(s))


@pytest.mark.parametrize("sigma", [np.float32(0.3), MG_PER_GENE])
def test_float32_mut_gaussian_matches_jit_python_zero_mu_tensor_sigma(sigma):
    """A Python ``mu`` of 0 with a traced ``sigma``: the add of 0 is
    dropped and the add to the gene is the FMA, as with constants."""
    fn = jax.jit(lambda k, v, s: jmut.mut_gaussian(k, v, 0.0, s, MG_INDPB))
    _mg_check(fn, (jnp.asarray(sigma),), 0.0, torch.from_numpy(
        np.asarray(sigma)))


def _mg_toolboxes(mu):
    """``bench.py``'s operators at a small size, with an exact fitness
    (the largest gene) so that selection cannot hide a gene's last bit."""
    jtb, ttb = jbase.Toolbox(), tbase.Toolbox()
    jtb.register("evaluate", lambda g: (jnp.max(g),))
    ttb.register("evaluate", lambda g: (torch.max(g),))
    jtb.register("mate", jcx.cx_two_point)
    ttb.register("mate", tcx.cx_two_point)
    jtb.register("mutate", jmut.mut_gaussian, mu=mu, sigma=0.3,
                 indpb=MG_INDPB)
    ttb.register("mutate", tmut.mut_gaussian, mu=mu, sigma=0.3,
                 indpb=MG_INDPB)
    jtb.register("select", jsel.sel_tournament, tournsize=3,
                 tie_break="rank")
    ttb.register("select", tsel.sel_tournament, tournsize=3,
                 tie_break="rank")
    jpop, tpop = _ga_populations(2)
    return jtb, ttb, j_eval(jtb, jpop)[0], t_eval(ttb, tpop)[0]


@pytest.mark.parametrize("mu", [0.0, 0.5])
def test_float32_mut_gaussian_in_the_xla_engine_generation(mu):
    """The program the xla engine's generation compiles: ``bench.py``'s
    body (split, ``sel_tournament``, row gather, ``vary_genome(pairing=
    "halves")``, evaluation) scanned over three generations, and the
    jitted ``ea_step``; both bitwise to the port."""
    from deap_tpu.algorithms import vary_genome as j_vary
    from deap_tpu_torch.algorithms import vary_genome as t_vary
    jtb, ttb, jpop, tpop = _mg_toolboxes(mu)

    def body(carry, _):
        key, pop = carry
        key, k_sel, k_var = jax.random.split(key, 3)
        idx = jtb.select(k_sel, pop.fitness, POP)
        genome, _ = j_vary(k_var, pop.genome[idx], jtb, CXPB, MUTPB,
                           pairing="halves")
        off = jbase.Population(genome, jbase.Fitness.empty(POP, (1.0,)))
        return (key, j_eval(jtb, off)[0]), None

    (_, jfin), _ = jax.jit(lambda k, p: jax.lax.scan(
        body, (k, p), None, length=NGEN))(jax.random.PRNGKey(5), jpop)
    key, pop = tr.PRNGKey(5, device="cpu"), tpop
    for _ in range(NGEN):
        key, k_sel, k_var = tr.split(key, 3)
        idx = ttb.select(k_sel, pop.fitness, POP)
        genome, _ = t_vary(k_var, pop.genome[idx], ttb, CXPB, MUTPB,
                           pairing="halves")
        off = tbase.Population(genome, tbase.Fitness.empty(
            POP, (1.0,), device="cpu"))
        pop = t_eval(ttb, off)[0]
    _same_population(jfin, pop)

    step = jax.jit(lambda k, p: j_ea_step(k, p, jtb, CXPB, MUTPB))
    jkey, tkey = jax.random.PRNGKey(7), tr.PRNGKey(7, device="cpu")
    for _ in range(NGEN):
        jkey, jpop, _ = step(jkey, jpop)
        tkey, tpop, _ = ea_step(tkey, tpop, ttb, CXPB, MUTPB)
    _same_population(jpop, tpop)
