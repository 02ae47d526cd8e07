"""The port's ES examples (``deap_tpu_torch/examples/es/``: cma_minfct,
cma_one_plus_lambda, onefifth, cma_mo, cma_bipop, cma_plotting) against
the JAX package's (``examples/es/``); their ``tests/test_examples.py``
checks are ``tests/test_torch_examples_rest_smoke.py``'s.

* onefifth and cma_mo are bitwise: the (1+1)-ES's final state (the JAX
  example's scan read through a wrapped ``lax.scan``) and MO-CMA-ES's
  whole strategy state after a cut run.
* The CMA-ES examples run ``eigh`` (or a Cholesky factor) a generation,
  whose eigenvectors carry no canonical sign and whose rounding differs
  between LAPACK and XLA, so they are held teacher-forced, a generation
  at a time from JAX's state and key, as ``tests/test_torch_cma.py``
  holds the strategies: every field within ``RTOL`` of its largest
  magnitude, ``pc`` and ``C`` where ``hsig``'s margin exceeds
  ``HSIG_MARGIN``.  The eigenvectors ``B`` are held through the square
  root ``B diag(diagD) Bᵀ`` of ``C`` (within ``RTOL``), which is unique:
  a restart's early covariances have nearly equal eigenvalues, whose
  eigenvectors may come back rotated within their eigenspace (not only
  negated) on another LAPACK.
* BIPOP: its first chunk teacher-forced a generation at a time (the JAX
  example's chunk program at ``CHUNK = 1``), the port's stopping test
  on every JAX chunk's state with the same decision, and the restart
  schedule (lambda, budget, sigma, centroid, evaluations) equal when
  the port's restarts are fed the JAX runs' results.
"""

import math

import numpy as np
import pytest
import torch

import jax

from deap_tpu import base as jbase
from deap_tpu.algorithms import evaluate_population as j_eval
from deap_tpu_torch import interop
from deap_tpu_torch.algorithms import ea_generate_update

torch.set_num_threads(1)

RTOL = 1e-5
HSIG_MARGIN = 1e-4
DEPTH = 8


class _Stop(Exception):
    pass


def _mods(name):
    import importlib
    return (importlib.import_module(f"examples.es.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.es.{name}"))


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _key(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


class _JaxRecorder:
    """Stands in for ``jax`` in an example module: ``jax.jit`` keeps every
    output of the jitted function (and, with ``limit``, stops the
    example after that many calls); the rest is jax's."""

    def __init__(self, seen, limit=None):
        self.seen, self.limit = seen, limit

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args, **kwargs):
            out = jitted(*args, **kwargs)
            self.seen.append((args, out))
            if self.limit is not None and len(self.seen) >= self.limit:
                raise _Stop
            return out
        return call

    def __getattr__(self, name):
        return getattr(jax, name)


def _hsig_margin(js, state) -> float:
    ps = np.asarray(state.ps, np.float64)
    t = int(state.update_count)
    lhs = (np.linalg.norm(ps) / math.sqrt(1 - (1 - js.cs) ** (2 * t))
           / js.chiN)
    return abs(lhs - (1.4 + 2.0 / (js.dim + 1.0)))


def _root(B, diagD):
    B = np.asarray(B, np.float64)
    return (B * np.asarray(diagD, np.float64)) @ B.T


def _check_cma_state(js, want, got):
    """The port's next state against JAX's, as tests/test_torch_cma.py."""
    assert int(got.update_count) == int(want.update_count)
    fields = ["centroid", "sigma", "ps", "diagD"]
    if _hsig_margin(js, want) > HSIG_MARGIN:
        fields += ["pc", "C"]
    for name in fields:
        assert _rel_err(getattr(got, name), getattr(want, name)) <= RTOL, \
            name
    root = _root(got.B.numpy(), got.diagD.numpy())
    assert _rel_err(root, _root(np.asarray(want.B),
                                np.asarray(want.diagD))) <= RTOL


def _to_torch_pop(pop, weights):
    return interop.population_to_torch(
        np.asarray(pop.genome), np.asarray(pop.fitness.values),
        np.asarray(pop.fitness.valid), weights, device="cpu")


def _teacher_forced_cma(jm, tm, js, ts, jtb, key, state, to_torch, check):
    """``DEPTH`` generations of each package's ``ea_generate_update``,
    each from JAX's key and state: the samples within ``RTOL`` (the same
    state and normals), then the next state by ``check``."""
    ttb = tm.toolbox(ts)
    for _ in range(DEPTH):
        jpop, jnext, _ = jm.ea_generate_update(key, jtb, state, ngen=1,
                                               weights=(-1.0,))
        tpop, tnext, _ = ea_generate_update(_key(key), ttb, to_torch(state),
                                            ngen=1, weights=(-1.0,))
        assert _rel_err(tpop.genome, jpop.genome) <= RTOL
        # the update on JAX's evaluated population, from JAX's state
        tnext = ts.update(to_torch(state), _to_torch_pop(jpop, (-1.0,)))
        check(jnext, tnext)
        key, state = jax.random.split(key)[0], jnext


def test_cma_minfct_teacher_forced():
    jm, tm = _mods("cma_minfct")
    js = jm.cma.Strategy(centroid=[5.0] * jm.N, sigma=5.0, lambda_=20)
    ts = tm.strategy_of("cpu")
    assert (ts.lambda_, ts.mu, ts.dim) == (js.lambda_, js.mu, js.dim)
    jtb = jbase.Toolbox()
    jtb.register("evaluate", jm.benchmarks.sphere)
    jtb.register("generate", js.generate)
    jtb.register("update", js.update)
    _teacher_forced_cma(
        jm, tm, js, ts, jtb, jax.random.PRNGKey(9), js.init(),
        lambda s: interop.cma_state_to_torch(s, device="cpu"),
        lambda want, got: _check_cma_state(js, want, got))


def test_cma_one_plus_lambda_teacher_forced():
    jm, tm = _mods("cma_one_plus_lambda")
    parent = jax.random.uniform(jax.random.PRNGKey(10), (jm.N,),
                                minval=-5.0, maxval=5.0)
    js = jm.cma.StrategyOnePlusLambda(parent, sigma=5.0, lambda_=10)
    ts = tm.strategy_of(10, "cpu")
    np.testing.assert_array_equal(ts.parent0.numpy(), np.asarray(parent))
    jtb = jbase.Toolbox()
    jtb.register("evaluate", jm.benchmarks.rastrigin)
    jtb.register("generate", js.generate)
    jtb.register("update", js.update)

    def check(want, got):
        for name in ("parent", "parent_wvalues", "parent_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("sigma", "psucc", "pc", "C", "A"):
            assert _rel_err(getattr(got, name),
                            getattr(want, name)) <= RTOL, name

    _teacher_forced_cma(
        jm, tm, js, ts, jtb, jax.random.PRNGKey(11), js.init(),
        lambda s: interop.one_plus_lambda_state_to_torch(s, device="cpu"),
        check)


def test_onefifth_bitwise(monkeypatch):
    """The JAX example's scan (its final carry and every step's
    fitness) read through a wrapped ``lax.scan``; the port's run equals
    it bit for bit."""
    jm, tm = _mods("onefifth")
    depth = 200
    monkeypatch.setattr(jm, "NGEN", depth)
    seen = []

    class Lax:
        def scan(self, *args, **kwargs):
            out = jax.lax.scan(*args, **kwargs)
            seen.append(out)
            return out

        def __getattr__(self, name):
            return getattr(jax.lax, name)

    monkeypatch.setattr(jm, "lax", Lax())
    want = jm.main(verbose=False)
    (jx, jsigma, jfx), _ = seen[-1]
    x, sigma, fx = tm.run(ngen=depth, device="cpu")
    for a, b in ((jx, x), (jsigma, sigma), (jfx, fx)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert want == tm.main(verbose=False, ngen=depth, device="cpu")


def test_cma_mo_bitwise(monkeypatch):
    """The whole MO-CMA-ES state after a cut run, bit for bit."""
    jm, tm = _mods("cma_mo")
    seen = []
    jcls = jm.cma.StrategyMultiObjective

    class Recorded(jcls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(jm.cma, "StrategyMultiObjective", Recorded)
    want = jm.main(ngen=30, verbose=False)
    got = tm.run(ngen=30, device="cpu")
    j = seen[-1]
    for name in ("parents", "parent_values", "sigmas", "A", "invCholesky",
                 "pc", "psucc"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(j, name)), name)
    assert want == tm.main(ngen=30, verbose=False, device="cpu")


def _capture_scan(monkeypatch, jm, run):
    """The JAX example's scanned body, first carry and inputs: ``jit`` is
    the identity and ``lax.scan`` records and stops."""
    rec = {}

    class Jax:
        def jit(self, fn, **kw):
            return fn

        def __getattr__(self, name):
            return getattr(jax, name)

    class Lax:
        def scan(self, f, init, xs, **kw):
            rec.update(f=f, init=init, xs=xs)
            raise _Stop

        def __getattr__(self, name):
            return getattr(jax.lax, name)

    monkeypatch.setattr(jm, "jax", Jax())
    monkeypatch.setattr(jm, "lax", Lax())
    with pytest.raises(_Stop):
        run()
    monkeypatch.undo()
    return rec


def test_cma_plotting_teacher_forced(monkeypatch, tmp_path):
    """The example's generation (its state, best value and vector, and
    every trace) a generation at a time from JAX's carry, then the figure
    from the port's run."""
    jm, tm = _mods("cma_plotting")
    rec = _capture_scan(monkeypatch, jm, lambda: jm.main(ngen=DEPTH,
                                                         verbose=False))
    step = jax.jit(rec["f"])
    js = jm.cma.Strategy(centroid=[5.0] * jm.N, sigma=5.0, lambda_=jm.LAMBDA)
    ts, ttb = tm.setup("cpu")
    carry = rec["init"]
    keys = rec["xs"]
    np.testing.assert_array_equal(
        np.asarray(keys),
        tm.random.split(tm.random.PRNGKey(64, device="cpu"), DEPTH).numpy())
    for k in keys:
        jc, jtr = step(carry, k)
        state, fbest, xbest = carry
        tc, ttr = tm.gen_step(ts, ttb, (
            interop.cma_state_to_torch(state, device="cpu"),
            _t(np.float32(fbest)), _t(np.asarray(xbest, np.float32))),
            _key(k))
        _check_cma_state(js, jc[0], tc[0])
        for name, v in jtr.items():
            assert _rel_err(ttr[name], v) <= RTOL, name
        carry = jc
    out = tmp_path / "cma.png"
    best = tm.main(ngen=DEPTH, out_png=str(out), verbose=False, device="cpu")
    assert np.isfinite(best)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _bipop_regimes(monkeypatch, jm, nrestarts):
    """The JAX example at ``NRESTARTS = nrestarts``: its result, every
    chunk's ``(inputs, outputs)`` and every regime's ``(arguments,
    result, chunks so far)``."""
    seen, regimes = [], []
    orig = jm._run_regime

    def recorded(*args):
        out = orig(*args)
        regimes.append((args, out, len(seen)))
        return out

    monkeypatch.setattr(jm, "NRESTARTS", nrestarts)
    monkeypatch.setattr(jm, "jax", _JaxRecorder(seen))
    monkeypatch.setattr(jm, "_run_regime", recorded)
    best = jm.main(verbose=False)
    return best, seen, regimes


def test_cma_bipop_first_chunk_teacher_forced(monkeypatch):
    """The first regime's first 50 generations, each from JAX's state:
    the JAX example's chunk program compiled at ``CHUNK = 1`` gives its
    state after every generation; the port's ``chunk`` of one generation
    from each must agree within ``RTOL``, its best value too."""
    jm, tm = _mods("cma_bipop")
    n_first = jm.CHUNK
    seen = []
    monkeypatch.setattr(jm, "CHUNK", 1)
    monkeypatch.setattr(jm, "jax", _JaxRecorder(seen, limit=n_first))
    lam = 4 + int(3 * math.log(jm.N))
    rng = np.random.RandomState(12)
    centroid = rng.uniform(-4, 4, jm.N)
    with pytest.raises(_Stop):
        jm.main(verbose=False)
    js = jm.cma.Strategy(centroid=centroid, sigma=jm.SIGMA0, lambda_=lam)
    ts = tm.cma.Strategy(centroid=centroid, sigma=tm.SIGMA0, lambda_=lam,
                         device="cpu")
    tb = tm.base.Toolbox()
    tb.register("evaluate", tm.benchmarks.rastrigin)
    assert len(seen) == n_first
    for (key, state), (jkey, jstate, jbests, _, _) in seen:
        tkey, tstate, tbests = tm.chunk(
            ts, tb, _key(key), interop.cma_state_to_torch(state, "cpu"),
            length=1)
        np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
        _check_cma_state(js, jstate, tstate)
        assert _rel_err(tbests, jbests) <= RTOL


def test_cma_bipop_stopping_and_schedule(monkeypatch):
    jm, tm = _mods("cma_bipop")
    want, seen, regimes = _bipop_regimes(monkeypatch, jm, nrestarts=3)
    # every chunk: the port's stopping test on JAX's state and the JAX
    # regime's history must decide as the JAX example did
    start = 0
    stops = 0
    for (_, _, _, lam, max_iter, _), _, end in regimes:
        hist = []
        for c in range(start, end):
            (_, _), (_, jstate, jbests, jtolx, jcond) = seen[c]
            hist.extend(np.asarray(jbests).tolist())
            tolx, cond = tm.stop_statistics(
                interop.cma_state_to_torch(jstate, "cpu"))
            assert tolx == bool(jtolx)
            assert _rel_err(cond, jcond) <= RTOL
            stopped = tm.regime_stops(hist, lam, tolx, cond)
            if c < end - 1:
                assert not stopped, c
            elif (c - start + 1) * jm.CHUNK < max_iter:
                assert stopped, c           # the JAX run broke off here
            stops += stopped
        start = end
    assert stops >= 1
    # the restart schedule: the port's restarts fed the JAX runs' results
    got_args = []
    results = iter([r for _, r, _ in regimes])

    def replay(k_run, centroid, sigma, lambda_, max_iter, evaluate,
               device=None):
        got_args.append((centroid, sigma, lambda_, max_iter))
        return next(results)

    monkeypatch.setattr(tm, "NRESTARTS", 3)
    monkeypatch.setattr(tm, "run_regime", replay)
    got = tm.main(verbose=False, device="cpu")
    assert got == want
    assert len(got_args) == len(regimes)
    for (centroid, sigma, lam, max_iter), (args, _, _) in zip(got_args,
                                                               regimes):
        _, jcentroid, jsigma, jlam, jmax_iter, _ = args
        assert (lam, max_iter) == (jlam, jmax_iter)
        assert sigma == jsigma
        np.testing.assert_array_equal(centroid, jcentroid)
