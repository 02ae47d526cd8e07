"""The port's ten library examples (``deap_tpu_torch/examples/``: the
multi-demic OneMax, DE basic / sphere / dynamic, PSO basic / multiswarm,
EMNA, PBIL, cooperative co-evolution and Hillis) against the JAX
package's (``examples/``); ``tests/test_torch_lib_examples_smoke.py``
holds each against its ``tests/test_examples.py`` check.

Each example runs in both packages from the same seed at a reduced
depth (the JAX example's module constant lowered, its loop compiled as
published).  The loop each example calls (``de``, ``de_step``, ``pso``,
``multiswarm_step``, ``ea_generate_update``, ``ea_cooperative``,
``ea_host_parasite``, or the returned demes) is wrapped on the JAX side
to read its final output, and the port's counterpart must equal it bit
for bit: genomes, fitness, swarm and strategy states, and the example's
own result.  Two float results are held within an ulp bound
(``ULP_BOUND``): the 20-gene sphere values of DE sphere (XLA vectorizes
that reduction inside the scan) and EMNA's sigma.
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

DEPTH = 8
# the examples the JAX package runs op by op (seconds a generation there)
DEPTH_OF = {"pso.multiswarm": 4, "de.dynamic": 5}
# (example, field): largest gap measured, in float32 ulps
ULP_BOUND = {("de.sphere", "values"): 3, ("eda.emna", "sigma"): 2}
# the loop each JAX example calls (wrapped to read its output); None:
# the example returns its population
LOOPS = {"ga.onemax_multidemic": None, "de.basic": "de", "de.sphere": "de",
         "de.dynamic": "de_step", "pso.basic": "pso",
         "pso.multiswarm": "multiswarm_step",
         "eda.emna": "ea_generate_update", "eda.pbil": "ea_generate_update",
         "coev.coop_evol": "ea_cooperative",
         "coev.hillis": "ea_host_parasite"}


def _mods(name):
    return (importlib.import_module(f"examples.{name}"),
            importlib.import_module(f"deap_tpu_torch.examples.{name}"))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _ulps(a, b) -> int:
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64)
            for v in (a, b))
    a, b = (np.where(v < 0, -(v & 0x7FFFFFFF), v) for v in (a, b))
    return int(np.abs(a - b).max()) if a.size else 0


def _check(name, field, want, got):
    want, got = np.atleast_1d(_np(want)), np.atleast_1d(_np(got))
    assert want.shape == got.shape, (name, field)
    bound = ULP_BOUND.get((name, field), 0)
    if bound and want.dtype == np.float32:
        assert _ulps(want, got) <= bound, (name, field)
    else:
        assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), \
            (name, field)


def _check_population(name, want, got):
    _check(name, "genome", want.genome, got.genome)
    _check(name, "values", want.fitness.values, got.fitness.values)
    _check(name, "valid", want.fitness.valid, got.fitness.valid)


def _record(monkeypatch, module, attr):
    """Wrap ``module.attr`` so that its last output is kept."""
    seen = []
    orig = getattr(module, attr)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(module, attr, wrapper)
    return seen


def _jax_run(name, jm, monkeypatch):
    """The JAX example at its depth: ``(its result, the outputs of its
    loop)``."""
    depth = DEPTH_OF.get(name, DEPTH)
    if hasattr(jm, "NGEN"):
        monkeypatch.setattr(jm, "NGEN", depth)
    if name == "de.dynamic":
        monkeypatch.setattr(jm, "CHANGE_EVERY", 2)
    seen = _record(monkeypatch, jm, LOOPS[name]) if LOOPS[name] else []
    kw = {"ngen": depth} if name == "pso.multiswarm" else {}
    if name == "ga.onemax_multidemic":
        return jm.main(**kw), seen
    return jm.main(verbose=False, **kw), seen


def _port(name, tm, monkeypatch):
    if name == "de.dynamic":     # changes after generations 2 and 4 of 5
        monkeypatch.setattr(tm, "CHANGE_EVERY", 2)
    return tm


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_example_against_jax(name, monkeypatch):
    jm, tm = _mods(name)
    want, seen = _jax_run(name, jm, monkeypatch)
    tm = _port(name, tm, monkeypatch)
    if name == "ga.onemax_multidemic":
        got = tm.main(verbose=False, ngen=DEPTH, device="cpu")
        _check_population(name, want, got)
    elif name in ("de.basic", "de.sphere"):
        got = tm.main(verbose=False, ngen=DEPTH, device="cpu")
        pops = [s[0] for s in seen]
        if name == "de.basic":
            port_pops = [tm.run(ngen=DEPTH, device="cpu")]
        else:
            port_pops = [tm.run(16, v, DEPTH, "cpu") for v in tm.VARIANTS]
        for a, b in zip(pops, port_pops):
            _check_population(name, a, b)
        if name == "de.basic":
            _check(name, "best", np.float32(want), np.float32(got))
        else:
            for v in tm.VARIANTS:
                _check(name, "values", np.float32(want[v]),
                       np.float32(got[v]))
    elif name == "de.dynamic":
        pop, errors = tm.run(ngen=DEPTH_OF[name], device="cpu")
        _check_population(name, seen[-1], pop)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(errors))
    elif name == "pso.basic":
        state = tm.run(ngen=DEPTH, device="cpu")
        for f in ("position", "speed", "pbest", "pbest_w", "gbest",
                  "gbest_w"):
            _check(name, f, getattr(seen[-1][0], f), getattr(state, f))
        assert want == -float(state.gbest_w)
    elif name == "pso.multiswarm":
        state, errors = tm.run(ngen=DEPTH_OF[name], device="cpu")
        for f in ("position", "speed", "pbest", "pbest_w", "sbest",
                  "sbest_w", "active"):
            _check(name, f, getattr(seen[-1][0], f), getattr(state, f))
        np.testing.assert_array_equal(np.asarray(want), np.asarray(errors))
    elif name == "eda.pbil":
        assert want == tm.main(verbose=False, ngen=DEPTH, device="cpu")
        jpop, jstate, _ = seen[-1]
        tpop, tstate = tm.run(ngen=DEPTH, device="cpu")
        _check_population(name, jpop, tpop)
        from deap_tpu_torch.interop import key_to_numpy
        _check(name, "prob_vector", jstate.prob_vector, tstate.prob_vector)
        _check(name, "key", jstate.key, key_to_numpy(tstate.key))
    elif name == "eda.emna":
        _emna_teacher_forced(jm, tm)
    elif name == "coev.coop_evol":
        species, reps = tm.run(ngen=DEPTH, device="cpu")
        jsp, jreps, _ = seen[-1]
        _check_population(name, jsp, species)
        _check(name, "reps", jreps, reps)
        assert want == float(reps.sum())
    elif name == "coev.hillis":
        hosts, paras = tm.run(ngen=DEPTH, device="cpu")
        jh, jp, _ = seen[-1]
        _check_population(name, jh, hosts)
        _check_population(name, jp, paras)
        assert want == tm.main(verbose=False, ngen=DEPTH, device="cpu")


def _emna_teacher_forced(jm, tm):
    """EMNA's sigma is within an ulp of XLA's and the next samples scale
    by it, so the example is held one generation at a time: from JAX's
    state and key, one generation of each package's ``ea_generate_update``
    (the samples and their values bit for bit, the centroid too, sigma
    within ``ULP_BOUND``)."""
    import jax
    from deap_tpu_torch import interop
    from deap_tpu_torch.algorithms import ea_generate_update
    js = jm.EMNA(centroid=[5.0] * jm.NDIM, sigma=5.0, mu=25, lambda_=100)
    ts = tm.EMNA(centroid=[5.0] * tm.NDIM, sigma=5.0, mu=25, lambda_=100,
                 device="cpu")
    jtb = jm.base.Toolbox()
    jtb.register("evaluate", jm.benchmarks.sphere)
    jtb.register("generate", js.generate)
    jtb.register("update", js.update)
    ttb = tm.toolbox(ts)
    key, state = jax.random.PRNGKey(18), js.init()
    for _ in range(DEPTH):
        jpop, jnext, _ = jm.ea_generate_update(key, jtb, state, ngen=1)
        tpop, tnext, _ = ea_generate_update(
            interop.key_to_torch(np.asarray(key), device="cpu"), ttb,
            interop.emna_state_to_torch(state, device="cpu"), ngen=1)
        _check_population("eda.emna", jpop, tpop)
        _check("eda.emna", "centroid", jnext.centroid, tnext.centroid)
        _check("eda.emna", "sigma", jnext.sigma, tnext.sigma)
        key, state = jax.random.split(key)[0], jnext


def test_hillis_network_against_jax():
    """The comparator network and the exhaustive check on random
    networks and inputs, bitwise to the JAX example's jitted ones."""
    import jax
    jm, tm = _mods("coev.hillis")
    rng = np.random.default_rng(4)
    nets = rng.integers(0, tm.N_WIRES, (16, tm.N_COMPARATORS, 2)).astype(
        np.int32)
    tests = (rng.uniform(size=(16, tm.N_TESTS, tm.N_WIRES)) < 0.5).astype(
        np.float32)
    want = jax.jit(jax.vmap(jm.apply_network))(nets.astype(np.float32),
                                               tests)
    got = tm.apply_network(torch.from_numpy(nets), torch.from_numpy(tests))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for i in range(4):
        all_in = np.array(np.meshgrid(*[[0, 1]] * tm.N_WIRES)).T.reshape(
            -1, tm.N_WIRES).astype(np.float32)
        out = np.asarray(jm.apply_network(nets[i].astype(np.float32),
                                          all_in))
        fails = int((~np.all(out[:, :-1] <= out[:, 1:], axis=1)).sum())
        assert fails == tm.exhaustive_failures(torch.from_numpy(nets[i]))
