"""The port's speciation PSO and cooperative / competitive co-evolution
examples (``deap_tpu_torch/examples/pso/speciation.py``,
``deap_tpu_torch/examples/coev/``: coop_base, coop_gen, coop_niche,
coop_adapt, symbreg) against the JAX package's (``examples/``); their
``tests/test_examples.py`` checks are
``tests/test_torch_examples_rest_smoke.py``'s.

Bit for bit throughout: the speciation step (fitness, species seeds,
positions and speeds) on every generation's JAX input, read through a
recording ``jax.jit``, and the whole run's result; the cooperative
examples' representatives, species and their own results at a cut
depth (the JAX loop read through the recording ``jax.jit``); the
coop_base pieces on random species; and the competitive symbolic
regression teacher-forced a generation at a time from JAX's carry (the
example's scanned body jitted alone: both populations, both champions
and both curves), then whole.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu_torch import interop

torch.set_num_threads(1)

# species-steps of the cooperative examples here (their defaults: 150,
# 200, 300)
COOP_NGEN = {"coev.coop_gen": 40, "coev.coop_niche": 40,
             "coev.coop_adapt": 60}
SYMBREG_TEACHER_GENS = 12
SYMBREG_NGEN = 20


class _Stop(Exception):
    pass


def _mods(name):
    return (importlib.import_module(f"examples.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.{name}"))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b):
    a, b = np.atleast_1d(_np(a)), np.atleast_1d(_np(b))
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _t(x):
    return torch.from_numpy(np.array(x))


def _key(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


class _JaxRecorder:
    """Stands in for ``jax`` in an example module: ``jax.jit`` keeps every
    call's inputs and outputs."""

    def __init__(self, seen):
        self.seen = seen

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def call(*args, **kwargs):
            out = jitted(*args, **kwargs)
            self.seen.append((args, kwargs, out))
            return out
        return call

    def __getattr__(self, name):
        return getattr(jax, name)


def test_speciation_every_step_and_run(monkeypatch):
    jm, tm = _mods("pso.speciation")
    seen = []
    monkeypatch.setattr(jm, "jax", _JaxRecorder(seen))
    want = jm.main(verbose=False)
    assert len(seen) == jm.NGEN
    for (key, pos, spd), _, out in seen:
        got = tm.step(_key(key), _t(pos), _t(spd))
        for a, b in zip(out, got):
            _same(a, b)
    pos, spd, counts = tm.run(device="cpu")
    _same(seen[-1][2][0], pos)
    _same(seen[-1][2][1], spd)
    assert counts == [int(jnp.unique(o[3]).shape[0]) for _, _, o in seen]
    assert want == tm.main(verbose=False, device="cpu")


def test_coop_base_pieces_against_jax():
    """Target sets, species, the match strengths and one round on random
    species, bit for bit against the JAX example's functions jitted."""
    jm, tm = _mods("coev.coop_base")
    key = jax.random.PRNGKey(3)
    for schema in jm.SCHEMATAS:
        for a, b in zip(jm.schema_arrays(schema), tm.schema_arrays(schema)):
            _same(a, b)
        _same(jm.init_target_set(key, schema, 10),
              tm.init_target_set(_key(key), schema, 10))
    targets = jnp.concatenate([jm.init_target_set(jax.random.fold_in(key, i),
                                                  s, 10)
                               for i, s in enumerate(jm.SCHEMATAS)])
    _same(targets, tm.target_set(_key(key), tm.SCHEMATAS, 30))
    species = jm.init_species(jax.random.PRNGKey(4), 3)
    _same(species, tm.init_species(_key(jax.random.PRNGKey(4)), 3))
    ts, tt = _t(species), _t(targets)
    for fn in ("match_set_strength", "match_set_strength_no_noise"):
        _same(jax.jit(getattr(jm, fn))(species[0], targets)[0],
              getattr(tm, fn)(ts[0], tt)[0])
    for rest in (species[1:, 0], species[:0, 0]):
        _same(jax.jit(jm.species_fitness)(species[0], rest, targets),
              tm.species_fitness(ts[0], _t(rest), tt))
    reps = species[:, 0]
    jtb, ttb = jm.make_toolbox(), tm.make_toolbox()
    k = jax.random.PRNGKey(5)
    want = jax.jit(lambda k, s, r: jm.evolve_round(k, s, r, targets, jtb))(
        k, species, reps)
    got = tm.evolve_round(_key(k), ts, _t(reps), tt, ttb)
    for a, b in zip(want, got):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(COOP_NGEN))
def test_cooperative_examples(name, monkeypatch):
    """The representatives and the example's result at a cut depth, and
    the species the JAX loop ends with."""
    jm, tm = _mods(name)
    seen = []
    monkeypatch.setattr(jm, "jax", _JaxRecorder(seen))
    ngen = COOP_NGEN[name]
    kw = {"adapt_length": 20} if name == "coev.coop_adapt" else {}
    jreps, jresult = jm.main(verbose=False, ngen=ngen, **kw)
    out = tm.run(ngen=ngen, device="cpu", **kw)
    species, reps = out[0], out[1]
    _same(seen[-1][2][0], species)
    _same(jreps, reps)
    treps, tresult = tm.main(verbose=False, ngen=ngen, device="cpu", **kw)
    _same(jreps, treps)
    assert jresult == tresult


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


def _carry_leaves(carry):
    ga, gp, best_ga, best_gp = carry
    return [ga, *gp, best_ga, *best_gp]


def test_coev_symbreg_teacher_forced(monkeypatch):
    jm, tm = _mods("coev.symbreg")
    ngen = SYMBREG_TEACHER_GENS
    rec = _capture_scan(monkeypatch, jm,
                        lambda: jm.main(verbose=False, ngen=ngen))
    ps = tm.build_pset()
    errors, tbs = tm.make_errors(ps), tm.toolboxes(ps)
    carry0, key = tm.initial(ps, 5, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(rec["init"]),
                    _carry_leaves(carry0)):
        _same(a, b)
    np.testing.assert_array_equal(np.asarray(rec["xs"]),
                                  tm.random.split(key, ngen).numpy())
    step = jax.jit(rec["f"])
    carry = rec["init"]
    for k in rec["xs"]:
        jnext, jout = step(carry, k)
        ga, gp, best_ga, best_gp = carry
        tnext, tout = tm.gen_step(
            errors, tbs, (_t(ga), tuple(_t(x) for x in gp), _t(best_ga),
                          tuple(_t(x) for x in best_gp)), _key(k))
        for a, b in zip(jax.tree_util.tree_leaves(jnext),
                        _carry_leaves(tnext)):
            _same(a, b)
        for a, b in zip(jout, tout):
            _same(a, b)
        carry = jnext


def test_coev_symbreg_whole_run():
    jm, tm = _mods("coev.symbreg")
    want = jm.main(verbose=False, ngen=SYMBREG_NGEN)
    assert want == tm.main(verbose=False, ngen=SYMBREG_NGEN, device="cpu")
