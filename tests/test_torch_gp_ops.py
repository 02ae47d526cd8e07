"""The rest of the port's GP layer against the jitted JAX package: the
remaining tree operators, ``static_limit``, the lexicase and
double-tournament selections, HARM-GP, ``graph``, the benchmark
functions, ADFs and the routine interpreter.

The same keys (made by JAX from a seed and carried as numpy words) go
through the JAX function, ``jax.vmap``ped over per-row keys as the JAX
package's loops call it, and through the port's row-batched
counterpart.  Integers (codes, lengths, picks, selected indices, the
HARM acceptance and cutoff, routine states) and float constants
(ephemeral draws, the semantic step) are held bit for bit; so are the
float values (HARM's histograms, the benchmark functions, ADF outputs):
the stated ulp bound is 0 everywhere.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, gp as jgp
from deap_tpu.benchmarks import gp as jbgp
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import base as tbase, gp as tgp, interop
from deap_tpu_torch import random as tr
from deap_tpu_torch.benchmarks import gp as tbgp
from deap_tpu_torch.ops import selection as tsel

torch.set_num_threads(1)

CAP, POP = 32, 48
ULP_BOUND = 0


def _same(a, b):
    """Bitwise equality of float or int arrays (NaNs of any payload
    equal)."""
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        b = b.astype(a.dtype)
        eq = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a)
                                                         & np.isnan(b))
        return bool(eq.all())
    return np.array_equal(a, b.astype(a.dtype))


def _tree_same(jt, tt):
    return all(_same(a, b) for a, b in zip(jt, tt))


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


def _to_torch(tree):
    return tuple(torch.from_numpy(np.array(x)) for x in tree)


# ---- primitive sets: bench_gp.py's, with lf for the semantic operators, a
# typed one, and one whose terminals are plain (no ephemeral) --------------

def _bench(g, lib, eph, lf=False, terminal=False):
    ps = g.PrimitiveSet("MAIN", 1)
    for f, a, n in ((lib.add, 2, "add"), (lib.subtract, 2, "sub"),
                    (lib.multiply, 2, "mul"), (g.protected_div, 2, "div"),
                    (lib.negative, 1, "neg"), (g.cos if g is tgp else
                                               jnp.cos, 1, "cos"),
                    (g.sin if g is tgp else jnp.sin, 1, "sin")):
        ps.add_primitive(f, a, name=n)
    if lf:
        ps.add_primitive(g.logistic, 1, name="lf")
    if terminal:
        ps.add_terminal(0.5, name="half")
    ps.add_ephemeral_constant("rand101", eph)
    return ps


@functools.lru_cache(maxsize=None)
def _psets(lf=False, terminal=False):
    return (_bench(jgp, jnp, lambda k: jax.random.randint(
                k, (), -1, 2).astype(jnp.float32), lf, terminal),
            _bench(tgp, torch, lambda k: tr.randint(k, (), -1, 2).float(),
                   lf, terminal))


@functools.lru_cache(maxsize=None)
def _typed_psets():
    """float and bool values, an if-then-else over them and a float
    ephemeral; ``ftob`` takes a type (int) without any terminal, so
    ``mut_insert`` must never pick it."""
    out = []
    for g, where, lt, u in (
            (jgp, jnp.where, jnp.less,
             lambda k: jax.random.uniform(k, (), jnp.float32, -1.0, 1.0)),
            (tgp, torch.where, torch.lt,
             lambda k: tr.uniform(k, (), minval=-1.0, maxval=1.0))):
        ps = g.PrimitiveSetTyped("TYPED", [float, float], float)
        ps.add_primitive(lambda a, b: a + b, [float, float], float,
                         name="add")
        ps.add_primitive(lambda a: -a, [float], float, name="neg")
        ps.add_primitive(lt, [float, float], bool, name="lt")
        ps.add_primitive(where, [bool, float, float], float, name="ite")
        ps.add_primitive(lambda a: a, [int], float, name="ftob")
        ps.add_terminal(1.0, bool, name="true")
        ps.add_terminal(0.0, bool, name="false")
        ps.add_ephemeral_constant("u", u, float)
        out.append(ps)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _trees(which, seed, n, lo, hi, cap=CAP, kind="half_and_half"):
    jp, tp = _typed_psets() if which == "typed" else _psets(
        lf=which == "sem", terminal=which == "term")
    jk, _ = _keys(seed, n)
    if which == "typed":
        # the ftob primitive makes generation impossible: build from a set
        # without it (same codes for the rest)
        jg = jgp.make_generator(_typed_gen_pset(), cap, kind)
    else:
        jg = jgp.make_generator(jp, cap, kind)
    jt = jax.jit(jax.vmap(lambda k: jg(k, lo, hi)))(jk)
    if which == "typed":
        # ftob is the fifth primitive: the terminals' codes move up one
        jt = (jnp.where(jt[0] >= 4, jt[0] + 1, jt[0]),) + tuple(jt[1:])
    return jp, tp, jt, _to_torch(jt)


@functools.lru_cache(maxsize=None)
def _typed_gen_pset():
    ps = jgp.PrimitiveSetTyped("TYPED", [float, float], float)
    ps.add_primitive(lambda a, b: a + b, [float, float], float, name="add")
    ps.add_primitive(lambda a: -a, [float], float, name="neg")
    ps.add_primitive(jnp.less, [float, float], bool, name="lt")
    ps.add_primitive(jnp.where, [bool, float, float], float, name="ite")
    ps.add_terminal(1.0, bool, name="true")
    ps.add_terminal(0.0, bool, name="false")
    ps.add_ephemeral_constant(
        "u", lambda k: jax.random.uniform(k, (), jnp.float32, -1.0, 1.0),
        float)
    return ps


# ---- the remaining tree operators -----------------------------------------

_ONE_TREE_OPS = {
    "mut_node_replacement": lambda g, ps: lambda k, t: g.mut_node_replacement(
        k, t, ps),
    "mut_ephemeral_one": lambda g, ps: lambda k, t: g.mut_ephemeral(
        k, t, ps, mode="one"),
    "mut_ephemeral_all": lambda g, ps: lambda k, t: g.mut_ephemeral(
        k, t, ps, mode="all"),
    "mut_insert": lambda g, ps: lambda k, t: g.mut_insert(k, t, ps),
    "mut_shrink": lambda g, ps: lambda k, t: g.mut_shrink(k, t, ps),
}


@pytest.mark.parametrize("which", ["bench", "term", "typed"])
@pytest.mark.parametrize("op", sorted(_ONE_TREE_OPS))
def test_mutations_bitwise(op, which):
    """Each mutation, one key a row; the JAX operator vmapped and
    jitted.  ``typed`` holds ``mut_insert`` to the ``fillable`` mask and
    to slots of the subtree's own type; ``term`` has a plain terminal."""
    jp, tp, jt, tt = _trees(which, 3, POP, 1, 5)
    jk, tk = _keys(17, POP)
    jf = jax.jit(jax.vmap(_ONE_TREE_OPS[op](jgp, jp)))
    tf = _ONE_TREE_OPS[op](tgp, tp)
    out = tf(tk, tt)
    assert _tree_same(jf(jk, jt), out)
    if op != "mut_shrink" or which != "typed":
        changed = (out[2] != tt[2]) | (out[0] != tt[0]).any(1) | (
            out[1] != tt[1]).any(1)
        assert int(changed.sum()) > 0


@pytest.mark.parametrize("op", ["mut_insert", "mut_shrink"])
def test_insert_shrink_full_capacity_bitwise(op):
    """Trees that fill most of a small capacity: inserted children that
    overflow keep their parent."""
    jp, tp, jt, tt = _trees("bench", 5, POP, 3, 4, cap=16, kind="full")
    jk, tk = _keys(23, POP)
    jf = jax.jit(jax.vmap(_ONE_TREE_OPS[op](jgp, jp)))
    out = _ONE_TREE_OPS[op](tgp, tp)(tk, tt)
    assert _tree_same(jf(jk, jt), out)
    if op == "mut_insert":
        assert bool((out[2] == tt[2]).any())          # an overflow row kept


def test_one_key_calling_form_equals_the_batch():
    """A rowwise operator called with one key and one tree (the JAX
    package's per-tree form) gives that row of the batched call."""
    _, tp, _, tt = _trees("bench", 3, POP, 1, 5)
    _, tk = _keys(17, POP)
    batch = tgp.mut_insert(tk, tt, tp)
    one = tgp.mut_insert(tk[5], tuple(x[5] for x in tt), tp)
    assert all(torch.equal(a[5], b) for a, b in zip(batch, one))


@pytest.mark.parametrize("cap,lo,hi", [(64, 1, 4), (24, 2, 3)])
def test_mut_semantic_bitwise(cap, lo, hi):
    """The default grow generator at depth 2-6, ``ms`` drawn as
    ``uniform(k_ms, (), 0, 2)``; at capacity 24 most children overflow
    and keep their parent."""
    jp, tp, jt, tt = _trees("sem", 7, POP, lo, hi, cap=cap)
    jk, tk = _keys(29, POP)
    jf = jax.jit(jax.vmap(lambda k, t: jgp.mut_semantic(k, t, jp)))
    out = tgp.mut_semantic(tk, tt, tp)
    assert _tree_same(jf(jk, jt), out)
    kept = (out[2] == tt[2]).sum()
    assert (0 < int(kept) < POP) if cap == 24 else int(kept) < POP
    if cap != 64:
        return
    # a given step, and the ephemeral carrying it when no terminal exists
    jf = jax.jit(jax.vmap(lambda k, t: jgp.mut_semantic(
        k, t, jp, ms=0.375, min_=1, max_=2)))
    assert _tree_same(jf(jk, jt), tgp.mut_semantic(tk, tt, tp, ms=0.375,
                                                   min_=1, max_=2))


@pytest.mark.parametrize("cap", [64, 28])
def test_cx_semantic_bitwise(cap):
    jp, tp, jt, tt = _trees("sem", 8, POP, 1, 4, cap=cap)
    h = POP // 2
    jk, tk = _keys(31, h)
    jf = jax.jit(jax.vmap(lambda k, a, b: jgp.cx_semantic(k, a, b, jp)))
    jc = jf(jk, tuple(x[:h] for x in jt), tuple(x[h:] for x in jt))
    tc = tgp.cx_semantic(tk, tuple(x[:h] for x in tt),
                         tuple(x[h:] for x in tt), tp)
    assert _tree_same(jc[0], tc[0]) and _tree_same(jc[1], tc[1])
    if cap == 28:
        kept = (tc[0][2] == tt[2][:h])
        assert 0 < int(kept.sum()) < h


def test_semantic_needs_its_primitives():
    _, tp = _psets()
    tt = _trees("bench", 3, POP, 1, 5)[3]
    _, tk = _keys(1, POP)
    with pytest.raises(AssertionError, match="'lf' function"):
        tgp.mut_semantic(tk, tt, tp)


@functools.lru_cache(maxsize=None)
def _jax_height(cap):
    arity = jnp.asarray(_psets()[0].freeze().arity)
    return lambda t: jgp.tree_height(t[0], t[2], arity)


def test_static_limit_both_forms_bitwise():
    """``static_limit(height, 4)`` around ``mut_uniform`` (one tree) and
    ``cx_one_point`` (two trees), in the batched form and in the one-key
    form; the JAX decorator jitted and vmapped."""
    jp, tp, jt, tt = _trees("bench", 9, POP, 2, 4)
    arity = tp.freeze().tables("cpu")["arity"]
    t_height = lambda t: tgp.tree_height(t[0], t[2], arity)  # noqa: E731
    jgen, tgen = (jgp.make_generator(jp, CAP, "full"),
                  tgp.make_generator(tp, CAP, "full"))
    jmut = jgp.static_limit(_jax_height(CAP), 4, jp)(
        lambda k, t: jgp.mut_uniform(k, t, lambda kk: jgen(kk, 0, 3), jp))
    tmut = tgp.static_limit(t_height, 4, tp)(tgp.mut_uniform)
    assert getattr(tmut, "rowwise", False)
    jk, tk = _keys(41, POP)
    jo = jax.jit(jax.vmap(jmut))(jk, jt)
    to = tmut(tk, tt, lambda kk: tgen(kk, 0, 3), tp)
    assert _tree_same(jo, to)
    assert int(t_height(to).max()) <= 4 or bool(
        (t_height(to) == t_height(tt)).all())
    one = tmut(tk[3], tuple(x[3] for x in tt), lambda kk: tgen(kk, 0, 3), tp)
    assert all(torch.equal(a[3], b) for a, b in zip(to, one))

    jcx = jgp.static_limit(_jax_height(CAP), 4, jp)(
        lambda k, a, b: jgp.cx_one_point(k, a, b, jp))
    tcx = tgp.staticLimit(t_height, 4, tp)(tgp.cx_one_point)
    h = POP // 2
    jk, tk = _keys(43, h)
    jc = jax.jit(jax.vmap(jcx))(jk, tuple(x[:h] for x in jt),
                               tuple(x[h:] for x in jt))
    tc = tcx(tk, tuple(x[:h] for x in tt), tuple(x[h:] for x in tt), tp)
    assert _tree_same(jc[0], tc[0]) and _tree_same(jc[1], tc[1])
    # an unmarked per-tree operator keeps its calling form
    plain = tgp.static_limit(lambda t: t[2], 3)(
        lambda k, t: tgp.mut_uniform(k, t, lambda kk: tgen(kk, 0, 3), tp))
    assert not getattr(plain, "rowwise", False)
    kid = plain(tk[0], tuple(x[0] for x in tt))
    assert int(kid[2]) <= 3 or int(kid[2]) == int(tt[2][0])


def test_gp_exports_every_name_of_the_jax_package():
    public = {n for n in dir(jgp) if not n.startswith("_")
              and not isinstance(getattr(jgp, n), type(jgp))}
    missing = sorted(n for n in public - {"jax", "jnp"}
                     if not hasattr(tgp, n))
    assert missing == []
    for n in ("sel_double_tournament", "sel_lexicase",
              "sel_epsilon_lexicase", "sel_automatic_epsilon_lexicase"):
        assert hasattr(tsel, n)


# ---- selection ---------------------------------------------------------------

def test_permutation_over_a_key_batch_bitwise():
    jk, tk = _keys(3, 37)
    for n in (1, 7, 128, 2000):                # 2000: two shuffle rounds
        jp = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n)))(jk)
        assert _same(jp, tr.permutation(tk, n))


def _cases(seed, n, ncases, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":                         # few distinct errors
        c = rng.integers(0, 4, (n, ncases)).astype(np.float32)
    else:
        c = rng.normal(size=(n, ncases)).astype(np.float32) ** 2
        c[: n // 4] = c[n // 4: 2 * (n // 4)]  # duplicated rows
    return -c                                  # maximize minus the error


@pytest.mark.parametrize("kind", ["ties", "continuous"])
@pytest.mark.parametrize("form", ["plain", "epsilon", "automatic"])
@pytest.mark.parametrize("n", [64, 63])
def test_lexicase_forms_bitwise(form, kind, n):
    """Every lexicase form on 64 and 63 candidates (even and odd median
    counts), tied and continuous case errors, k above n (64) and below
    it (63)."""
    cases = _cases(n + len(form), n, 40, kind)
    for k in ((n + 9,) if n % 2 == 0 else (17,)):
        key = jax.random.PRNGKey(k + n)
        tk = torch.from_numpy(np.asarray(key).astype(np.int64))
        tc = torch.from_numpy(cases)
        if form == "plain":
            j = jax.jit(jsel.sel_lexicase, static_argnums=2)(key, cases, k)
            t = tsel.sel_lexicase(tk, tc, k)
        elif form == "epsilon":
            j = jax.jit(lambda kk, c: jsel.sel_epsilon_lexicase(
                kk, c, k, 0.3))(key, cases)
            t = tsel.sel_epsilon_lexicase(tk, tc, k, 0.3)
        else:
            j = jax.jit(jsel.sel_automatic_epsilon_lexicase,
                        static_argnums=2)(key, cases, k)
            t = tsel.sel_automatic_epsilon_lexicase(tk, tc, k)
        assert _same(j, t)


def test_nanmedian_is_jaxs_weighted_middle():
    from deap_tpu_torch.ops.selection import _nanmedian
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 33)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = np.nan
    x[3] = np.nan
    x[4, :] = 2.5
    x[4, 7] = np.nan
    j = jax.jit(lambda a: jnp.nanmedian(a, axis=1))(x)
    assert _same(j, _nanmedian(torch.from_numpy(x)))


@pytest.mark.parametrize("fitness_first", [True, False])
def test_double_tournament_bitwise(fitness_first):
    rng = np.random.default_rng(7)
    n = 50
    w = rng.integers(0, 6, (n, 2)).astype(np.float32)     # ties
    sizes = rng.integers(1, 9, n).astype(np.int32)
    key = jax.random.PRNGKey(3)
    tk = torch.from_numpy(np.asarray(key).astype(np.int64))
    for k, fs, ps in ((n, 3, 1.4), (31, 5, 2.0)):
        j = jax.jit(lambda kk, ww, ss: jsel.sel_double_tournament(
            kk, ww, ss, k, fs, ps, fitness_first))(key, w, sizes)
        t = tsel.sel_double_tournament(tk, torch.from_numpy(w),
                                       torch.from_numpy(sizes), k, fs, ps,
                                       fitness_first)
        assert _same(j, t)
    # a Fitness with invalid rows: they lose every comparison
    jf = jbase.Fitness(jnp.asarray(w), jnp.asarray(np.arange(n) % 3 > 0),
                       (1.0, -1.0))
    tf = tbase.Fitness(torch.from_numpy(w), torch.from_numpy(
        np.arange(n) % 3 > 0), (1.0, -1.0))
    j = jsel.sel_double_tournament(key, jf, sizes, n, 3, 1.4, fitness_first)
    t = tsel.sel_double_tournament(tk, tf, torch.from_numpy(sizes), n, 3,
                                   1.4, fitness_first)
    assert _same(j, t)


# ---- HARM-GP ------------------------------------------------------------------

_KDE = ((-2, 0.1), (-1, 0.2), (0, 0.4), (1, 0.2), (2, 0.1))


@functools.lru_cache(maxsize=None)
def _jax_harm_steps(n, nbins, alpha, beta, gamma, rho, mincutoff):
    """Steps 2-5 of ``deap_tpu.gp.harm``'s generation, as written there,
    jitted: the histogram, the cutoff, the target and the acceptance."""
    import math
    ln2 = math.log(2.0)

    def steps(key, sizes, wv):
        m = sizes.shape[0]
        hist = jnp.zeros((nbins,), jnp.float32)
        for off, w in _KDE:
            b = sizes + off
            ok = (b >= 0) & (b < nbins)
            hist = hist.at[jnp.where(ok, b, nbins - 1)].add(
                jnp.where(ok, w, 0.0))
        natural_hist = hist * (n / m)
        order = jbase.lex_sort_indices(wv, descending=False)
        cutoff = jnp.maximum(mincutoff, jnp.min(sizes[order[int(n * rho)
                                                             - 1:]]))
        bins = jnp.arange(nbins, dtype=jnp.float32)
        hl = bins * alpha + beta
        target_fn = (gamma * n * ln2 / hl) * jnp.exp(
            -ln2 * (bins - cutoff.astype(jnp.float32)) / hl)
        target_hist = jnp.where(bins <= cutoff, natural_hist, target_fn)
        prob_hist = jnp.where(natural_hist > 0,
                              target_hist / jnp.maximum(natural_hist, 1e-30),
                              target_hist)
        u = jax.random.uniform(key, (m,))
        accept = u <= prob_hist[jnp.clip(sizes, 0, nbins - 1)]
        rank = jnp.where(accept, jnp.arange(m), m + jnp.arange(m))
        by_accept = jnp.argsort(rank)
        n_acc = jnp.sum(accept)
        slots = jnp.arange(n) % jnp.maximum(n_acc, 1)
        chosen = jnp.where(n_acc > 0, by_accept[slots], jnp.arange(n))
        return chosen, cutoff, natural_hist, prob_hist

    return jax.jit(steps)


@pytest.mark.parametrize("case", ["collide", "spread", "reject_all"])
def test_harm_histogram_cutoff_acceptance_bitwise(case):
    """The five scatter-adds on 4096 sizes that pile into few bins (each
    bin's sum rounds thousands of times), the cutoff over masked fitness
    with ties, the target and acceptance; ``reject_all`` has every size
    above a cutoff that rejects them (the ``n_acc == 0`` branch)."""
    from deap_tpu_torch.gp.harm import acceptance
    rng = np.random.default_rng(11)
    m, n, cap = 4096, 512, 64
    nbins = cap + 3
    if case == "collide":
        sizes = np.where(rng.random(m) < 0.8, 31,
                         rng.integers(0, cap + 1, m))
    elif case == "spread":
        sizes = rng.integers(1, cap + 1, m)
    else:
        sizes = np.full(m, cap)
    sizes = sizes.astype(np.int32)
    wv = rng.integers(-3, 0, (m, 1)).astype(np.float32)
    wv[rng.random(m) < 0.3] = -np.inf
    params = (n, nbins, 0.05, 10.0, 0.25 if case != "reject_all" else 1e-30,
              0.9, 10)
    key = jax.random.PRNGKey(5)
    j = _jax_harm_steps(*params)(key, sizes, wv)
    t = acceptance(torch.from_numpy(np.asarray(key).astype(np.int64)),
                   torch.from_numpy(sizes), torch.from_numpy(wv), n,
                   0.05, 10.0, params[4], 0.9, 10, nbins)
    for a, b in zip(j, t):
        assert _same(a, b)
    if case == "reject_all":
        assert np.array_equal(np.asarray(j[0]), np.arange(n))


def _depth_0_2(gen):
    return lambda kk: gen(kk, 0, 2)


def _harm_toolboxes(cap=32, n_points=20):
    """A symbolic-regression toolbox in both packages whose fitness is
    exact in float32: the number of points within 0.25 of the target."""
    jp, tp = _psets()
    xs = np.linspace(-1, 1, n_points).astype(np.float32)
    target = xs * xs + xs
    out = []
    for g, ps in ((jgp, jp), (tgp, tp)):
        X = (jnp.asarray(xs)[None, :] if g is jgp
             else torch.from_numpy(xs)[None, :])
        tgt = jnp.asarray(target) if g is jgp else torch.from_numpy(target)
        ev = g.make_evaluator(ps, cap)
        gen_mut = g.make_generator(ps, cap, "full")
        base = jbase if g is jgp else tbase
        sel = jsel if g is jgp else tsel
        tb = base.Toolbox()
        if g is jgp:
            def evaluate(tree, ev=ev, X=X, tgt=tgt):
                out = ev(tree[0], tree[1], tree[2], X)
                return (jnp.sum(jnp.abs(out - tgt) < 0.25).astype(
                    jnp.float32),)
            tb.register("evaluate", evaluate)
            tb.register("mate", lambda k, a, b: jgp.cx_one_point(k, a, b, jp))
            tb.register("mutate", lambda k, t, g=gen_mut: jgp.mut_uniform(
                k, t, lambda kk: g(kk, 0, 2), jp))
        else:
            def evaluate(genome, skip=None, ev=ev, X=X, tgt=tgt):
                out = ev(genome[0], genome[1], genome[2], X)
                return ((out - tgt).abs() < 0.25).sum(dim=1).float()
            tb.register("evaluate_population", evaluate)
            tb.register("mate", tgp.cx_one_point, pset=tp)
            tb.register("mutate", tgp.mut_uniform,
                        expr=_depth_0_2(gen_mut), pset=tp)
        tb.register("select", sel.sel_tournament, tournsize=3)
        out.append(tb)
    return out


def test_harm_generations_bitwise():
    """Three HARM generations (pop 48, 256 natural children) on a
    fitness that is exact in float32, so nothing needs teacher forcing:
    trees, fitness and the logbook's evaluation counts bit for bit."""
    jtb, ttb = _harm_toolboxes()
    jp, tp, jt, tt = _trees("bench", 13, POP, 1, 3)
    jpop = jbase.Population(jt, jbase.Fitness.empty(POP, (1.0,)))
    tpop = tbase.Population(tt, tbase.Fitness.empty(POP, (1.0,),
                                                    device="cpu"))
    key = jax.random.PRNGKey(77)
    opts = dict(cxpb=0.8, mutpb=0.15, ngen=3, nbrindsmodel=256,
                mincutoff=8)
    jout, jlog = jgp.harm(key, jpop, jtb, **opts)
    tout, tlog = tgp.harm(interop.key_to_torch(key, "cpu"), tpop, ttb,
                          **opts)
    assert _tree_same(jout.genome, tout.genome)
    assert _same(jout.fitness.values, tout.fitness.values)
    assert [int(r["nevals"]) for r in jlog] == [int(r["nevals"])
                                                 for r in tlog]
    assert len(tlog) == 4


# ---- graph, benchmark functions ---------------------------------------------

def test_graph_equals_jax():
    jp, tp, jt, tt = _trees("bench", 3, POP, 1, 5)
    for i in range(0, POP, 7):
        jtree = tuple(np.asarray(x[i]) for x in jt)
        ttree = tuple(x[i] for x in tt)
        assert jgp.graph(jtree, jp) == tgp.graph(ttree, tp)


@pytest.mark.parametrize("name", tbgp.__all__)
def test_benchmark_functions_bitwise(name):
    """On points whose results stay normal (XLA flushes subnormal results
    to zero; the port keeps them)."""
    rng = np.random.default_rng(3)
    data = rng.uniform(-4, 8, (4000, 3)).astype(np.float32)
    j = jax.jit(jax.vmap(getattr(jbgp, name)))(data)
    t = getattr(tbgp, name)(torch.from_numpy(data.T.copy()))
    assert _same(j, t)
    assert _same(j[:5], torch.stack([getattr(tbgp, name)(
        torch.from_numpy(d)) for d in data[:5]]))


# ---- ADFs ---------------------------------------------------------------------

def _adf_psets(g, lib):
    adf1 = g.PrimitiveSet("ADF1", 2)
    adf1.add_primitive(lib.add, 2, name="add")
    adf1.add_primitive(lib.multiply, 2, name="mul")
    adf0 = g.PrimitiveSet("ADF0", 2)
    adf0.add_primitive(lib.add, 2, name="add")
    adf0.add_primitive(lib.subtract, 2, name="sub")
    adf0.add_adf(adf1)
    main = g.PrimitiveSet("MAIN", 1)
    main.add_primitive(lib.add, 2, name="add")
    main.add_primitive(lib.multiply, 2, name="mul")
    main.add_adf(adf0)
    main.add_adf(adf1)
    main.rename_arguments(ARG0="x")
    return main, adf0, adf1


def test_adf_nested_case_bitwise():
    """``tests/test_gp.py``'s nested case: main calls ADF0, which calls
    ADF1; ``compile_adf`` and the population evaluator."""
    cap = 32
    jps, tps = _adf_psets(jgp, jnp), _adf_psets(tgp, torch)
    srcs = ("add(ADF0(x, x), x)", "sub(ADF1(ARG0, ARG1), ARG1)",
            "add(mul(ARG0, ARG1), ARG0)")
    jtrees = tuple(jgp.from_string(s, p, cap=cap) for s, p in zip(srcs, jps))
    ttrees = tuple(tgp.from_string(s, p, cap=cap) for s, p in zip(srcs, tps))
    xs = np.linspace(-2, 2, 7).astype(np.float32)
    jf, tf = jgp.compile_adf(jtrees, jps, cap=cap), tgp.compileADF(
        ttrees, tps, cap=cap)
    assert _same(jf(xs), tf(xs))
    assert jf(1.5) == tf(1.5)
    np.testing.assert_allclose(tf(xs).numpy(), xs ** 2 + xs, rtol=1e-5)
    with pytest.raises(TypeError):
        tf(xs, xs[:3])


def test_adf_population_evaluator_bitwise():
    """Generated populations of main and ADF trees (every ADF node
    reached on some rows, none on others) through both nested machines."""
    cap, n = 24, 40
    jps, tps = _adf_psets(jgp, jnp), _adf_psets(tgp, torch)
    trees_j = []
    for i, p in enumerate(jps):
        g = jgp.make_generator(p, cap, "half_and_half")
        jk, _ = _keys(50 + i, n)
        trees_j.append(jax.jit(jax.vmap(lambda k: g(k, 1, 3)))(jk))
    trees_j = tuple(trees_j)
    X = np.linspace(-1.5, 1.5, 11).astype(np.float32)[None, :]
    j = jax.jit(jgp.make_adf_population_evaluator(jps, cap))(trees_j, X)
    t = tgp.make_adf_population_evaluator(tps, cap)(
        tuple(_to_torch(t) for t in trees_j), torch.from_numpy(X))
    assert _same(j, t)
    one = tgp.make_adf_evaluator(tps, cap)(
        tuple(tuple(x[3] for x in _to_torch(t)) for t in trees_j),
        torch.from_numpy(X))
    assert _same(np.asarray(j[3]), one)


def test_adf_cycle_raises():
    a = tgp.PrimitiveSet("A", 1)
    b = tgp.PrimitiveSet("B", 1)
    a.add_adf(b)
    b.add_adf(a)
    with pytest.raises(ValueError, match="cyclic ADF reference"):
        tgp.make_adf_evaluator((a, b), 8)


# ---- the routine interpreter on the artificial ant ---------------------------

def test_routine_interpreter_on_the_ant_bitwise():
    """Random routines of the ant's set (capacity 128) on the Santa Fe
    trail, the JAX interpreter ``jax.vmap``ped: every field of the final
    state, food grid included."""
    from examples.gp import ant as jant
    from deap_tpu_torch.examples.gp import ant as tant
    n = 24
    jps, tps = jant.build_pset(), tant.build_pset()
    g = jgp.make_generator(jps, tant.CAP, "half_and_half")
    jk, _ = _keys(9, n)
    jt = jax.jit(jax.vmap(lambda k: g(k, 1, 5)))(jk)
    conds = {"if_food_ahead": jant.sense_food}
    acts = {"move_forward": jant.move_forward, "turn_left": jant.turn_left,
            "turn_right": jant.turn_right}
    jrun = jgp.make_routine_interpreter(
        jps, tant.CAP, acts, conds, lambda s: s["moves"] < jant.MAX_MOVES)
    jfinal = jax.jit(jax.vmap(lambda t: jrun(t, jant.init_state())))(jt)
    trun = tgp.make_routine_interpreter(
        tps, tant.CAP,
        {"move_forward": tant.move_forward, "turn_left": tant.turn_left,
         "turn_right": tant.turn_right},
        {"if_food_ahead": tant.sense_food},
        lambda s: s["moves"] < tant.MAX_MOVES)
    tfinal = trun(_to_torch(jt), tant.init_state(n))
    for k in ("row", "col", "dir", "moves", "eaten", "food"):
        assert _same(jfinal[k], tfinal[k]), k
    assert int(tfinal["eaten"].max()) > 0


def test_routine_max_steps_and_validation():
    """An action-free routine stops at ``max_steps``; a terminal without
    an action or a conditional that is not binary raises."""
    ps = tgp.PrimitiveSet("R", 0)
    ps.add_primitive(None, 2, name="prog2")
    ps.add_terminal(0.0, name="noop")
    run = tgp.make_routine_interpreter(
        ps, 8, {"noop": lambda s: s}, {},
        lambda s: torch.ones(s.shape[0], dtype=torch.bool), max_steps=40)
    tree = tuple(torch.as_tensor(x) for x in tgp.from_string(
        "prog2(noop, noop)", ps, cap=8))
    out = run(tuple(x[None] for x in tree), torch.zeros(1))
    assert out.shape == (1,)
    with pytest.raises(ValueError, match="has no action"):
        tgp.make_routine_interpreter(ps, 8, {}, {}, lambda s: s)
    with pytest.raises(ValueError, match="binary primitive"):
        tgp.make_routine_interpreter(ps, 8, {"noop": lambda s: s},
                                     {"noop": lambda s: s}, lambda s: s)


def test_lexicase_early_exit_equals_the_whole_case_loop(monkeypatch):
    """Rows whose candidates all share one case vector (copies of one
    program, NaN cases among them) are final: ending the loop there
    picks what running every case picks."""
    import deap_tpu_torch.ops.selection as S
    rng = np.random.default_rng(9)
    base_rows = rng.integers(0, 3, (12, 96)).astype(np.float32)
    cases = base_rows[rng.integers(0, 12, 80)]           # many copies
    cases[5, 7] = np.nan
    cases[6] = cases[5]
    tc = torch.from_numpy(-cases)
    key = tr.PRNGKey(4, device="cpu")
    fast = [f(key, tc) for f in (
        lambda k, c: S.sel_lexicase(k, c, 80),
        lambda k, c: S.sel_automatic_epsilon_lexicase(k, c, 80))]
    monkeypatch.setattr(S, "_LEXICASE_CHECK", 10 ** 9)
    full = [f(key, tc) for f in (
        lambda k, c: S.sel_lexicase(k, c, 80),
        lambda k, c: S.sel_automatic_epsilon_lexicase(k, c, 80))]
    assert all(torch.equal(a, b) for a, b in zip(fast, full))


def test_routine_check_interval_changes_nothing(monkeypatch):
    import deap_tpu_torch.gp.routine as R
    from deap_tpu_torch.examples.gp import ant as tant
    ps = tant.build_pset()
    _, tk = _keys(3, 6)
    trees = tgp.make_generator(ps, tant.CAP, "half_and_half")(tk, 1, 4)
    outs = []
    for every in (1, 5, 64):
        monkeypatch.setattr(R, "CHECK_EVERY", every)
        run = tgp.make_routine_interpreter(
            ps, tant.CAP,
            {"move_forward": tant.move_forward, "turn_left": tant.turn_left,
             "turn_right": tant.turn_right},
            {"if_food_ahead": tant.sense_food},
            lambda s: s["moves"] < 100)
        outs.append(run(trees, tant.init_state(6)))
    for o in outs[1:]:
        assert all(torch.equal(o[k], outs[0][k]) for k in o)
