"""The port's eight GP examples (``deap_tpu_torch/examples/gp/``) against
the JAX package's (``examples/gp/``), and each at ``tests/test_examples.py``'s
depth against its quality check.

Teacher forcing: each JAX example's loop (``algorithms.ea_simple`` or
``gp.harm``) is intercepted to read its key, initial population and
toolbox, and so is the port's; then a few generations run in both
packages from the SAME population and key (the JAX output of the
generation before).  Trees, keys, validity and evaluation counts must be
equal bit for bit, and the fitness too where it is exact (counts, per-case
absolute errors, accuracies).  Where the fitness is a mean of squares the
JAX package's value depends on where XLA compiles the mean: its CPU
backend fuses each square into the running sum inside the generation's
loop and rounds it separately outside it, and the port takes the latter
form (``_xla_math.row_mean``) everywhere, so there the fitness is held
within ``MSE_ULP_BOUND`` units in the last place.
"""

import numpy as np
import pytest
import torch

import jax

import deap_tpu.algorithms as jalg
import deap_tpu.gp as jgp
from deap_tpu_torch import algorithms as talg, gp as tgp, interop

torch.set_num_threads(1)

# symbreg / HARM / ADF: a 20-term float32 sum of squares, fused or not
MSE_ULP_BOUND = 4
TEACHER_GENS = 2
EXAMPLES = ["symbreg", "symbreg_epsilon_lexicase", "symbreg_harm",
            "adf_symbreg", "ant", "multiplexer", "parity", "spambase"]
MSE_FITNESS = {"symbreg", "symbreg_harm", "adf_symbreg"}


class _Stop(Exception):
    pass


def _modules(name):
    import importlib
    return (importlib.import_module(f"examples.gp.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.gp.{name}"))


def _capture(monkeypatch, owner, attr, run):
    """Run ``run()`` with ``owner.attr`` (the loop) replaced by a recorder
    that stops the example: ``(key, population, toolbox, kwargs)``."""
    rec = {}

    def stub(key, pop, tb, *args, **kwargs):
        rec.update(key=key, pop=pop, tb=tb, kwargs=kwargs)
        raise _Stop

    monkeypatch.setattr(owner, attr, stub)
    with pytest.raises(_Stop):
        run()
    monkeypatch.undo()
    return rec


def _leaves(g):
    if isinstance(g, (tuple, list)):
        return [x for v in g for x in _leaves(v)]
    return [g]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def _check(name, jpop, tpop):
    """Trees bit for bit; the fitness bit for bit or within the bound."""
    for a, b in zip(_leaves(jpop.genome), _leaves(tpop.genome)):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jpop.fitness.valid),
                          tpop.fitness.valid.numpy())
    jv = np.asarray(jpop.fitness.values)
    tv = tpop.fitness.values.numpy()
    if name in MSE_FITNESS:
        assert _ulps(jv, tv) <= MSE_ULP_BOUND
    else:
        assert np.array_equal(jv.view(np.uint32), tv.view(np.uint32))


def _to_torch(jpop):
    return interop.population_to_torch(
        jpop.genome, jpop.fitness.values, jpop.fitness.valid,
        jpop.fitness.weights, device="cpu")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_teacher_forced(name, monkeypatch):
    J, T = _modules(name)
    harm = name == "symbreg_harm"
    jr = _capture(monkeypatch, jgp if harm else jalg,
                  "harm" if harm else "ea_simple",
                  lambda: J.main(verbose=False))
    tr_ = _capture(monkeypatch, tgp if harm else T,
                   "harm" if harm else "ea_simple",
                   lambda: T.main(verbose=False, device="cpu"))
    # the same key and initial trees
    assert np.array_equal(np.asarray(jr["key"]), tr_["key"].numpy())
    for a, b in zip(_leaves(jr["pop"].genome), _leaves(tr_["pop"].genome)):
        assert np.array_equal(np.asarray(a), b.numpy())
    kw = {k: v for k, v in jr["kwargs"].items()
          if isinstance(v, (int, float, bool))}
    assert kw == {k: v for k, v in tr_["kwargs"].items() if k in kw}
    assert set(jr["kwargs"]) == set(tr_["kwargs"])
    jtb, ttb = jr["tb"], tr_["tb"]
    if harm:
        opts = {k: v for k, v in kw.items() if k != "ngen"}
        jk, jpop = jr["key"], jr["pop"]
        tpop = tr_["pop"]
        for _ in range(TEACHER_GENS):
            jout, _ = jgp.harm(jk, jpop, jtb, ngen=1, **opts)
            tout, _ = tgp.harm(interop.key_to_torch(jk, "cpu"), tpop, ttb,
                               ngen=1, **opts)
            _check(name, jout, tout)
            jk, jpop = jax.random.split(jk, 4)[0], jout
            tpop = _to_torch(jout)
        return
    # ea_simple: its key split and initial evaluation, then ea_step
    jk, _ = jax.random.split(jr["key"])
    jpop, _ = jalg.evaluate_population(jtb, jr["pop"])
    tpop, _ = talg.evaluate_population(ttb, tr_["pop"])
    _check(name, jpop, tpop)
    cx, mut = kw["cxpb"], kw["mutpb"]
    step = jax.jit(lambda k, p: jalg.ea_step(k, p, jtb, cx, mut))
    for _ in range(TEACHER_GENS):
        jk2, jout, jn = step(jk, jpop)
        tk2, tout, tn = talg.ea_step(interop.key_to_torch(jk, "cpu"),
                                     _to_torch(jpop), ttb, cx, mut)
        assert np.array_equal(np.asarray(jk2), tk2.numpy())
        assert int(jn) == int(tn)
        _check(name, jout, tout)
        jk, jpop = jk2, jout


# tests/test_examples.py's depths and checks (tests/test_gp.py's HARM size
# control for symbreg_harm)
DEPTHS = {
    "symbreg": (dict(ngen=25), None),
    "symbreg_epsilon_lexicase": (dict(ngen=15), None),
    "symbreg_harm": (dict(ngen=3), None),
    "adf_symbreg": (dict(ngen=5), None),
    "multiplexer": (dict(ngen=25), lambda r: r >= 56),
    "parity": (dict(ngen=10), lambda r: r >= 8),
    "spambase": (dict(ngen=8), lambda r: r >= 0.6),
    "ant": (dict(ngen=3), lambda r: r >= 20),
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_at_test_depth(name):
    _, T = _modules(name)
    kwargs, check = DEPTHS[name]
    out = T.main(verbose=False, device="cpu", **kwargs)
    if check is not None:
        assert check(out), out
    if hasattr(out, "genome"):
        values = out.fitness.values
        assert bool(out.fitness.valid.all())
        assert bool(torch.isfinite(values).all())
    if name == "symbreg_harm":
        assert float(out.genome[2].float().mean()) < T.CAP * 0.8


def test_ant_evaluates_one_tree_as_a_batch_of_one():
    """The ant's ``evaluate`` also takes one tree (the JAX example's
    per-tree calling form) and gives that row of the batch."""
    from deap_tpu_torch.examples.gp import ant
    ps = ant.build_pset()
    tree = tgp.from_string("if_food_ahead(move_forward, turn_left)", ps,
                           cap=ant.CAP)
    tree = tuple(torch.as_tensor(x) for x in tree)
    ev = ant.make_evaluate(ps)
    one = ev(tree)[0]
    batch = ev(tuple(x[None] for x in tree))[0]
    assert one.ndim == 0 and float(one) == float(batch[0]) > 0
