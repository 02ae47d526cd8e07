"""The rest of the port's library against the JAX package on the CPU:
``creator``, ``ops.init``, the ``tools`` façade, ``ops.migration``,
``utils.checkpoint`` and ``utils.compilecache``.

Every comparison is with the jitted JAX function on the same inputs
(numpy from a seed) and keys, bit for bit: the initializers and
``init_population`` under threefry and rbg keys (an rbg batch draws every
row from its first key, as jax's vmap does), the migration's slots and
genomes with a cyclic and a non-cyclic ``migarray``.  The checkpoint
tests hold a resumed run bitwise to the undisturbed one.
"""

import dataclasses
import pathlib
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import base as jbase, creator as jcreator, tools as jtools
from deap_tpu.ops import init as jinit, migration as jmig
from deap_tpu.ops import selection as jsel
from deap_tpu_torch import base as tbase, creator as tcreator, interop
from deap_tpu_torch import random as tr, tools as ttools
from deap_tpu_torch.ops import init as tinit, migration as tmig
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.utils import checkpoint as tck, compilecache as tcc

torch.set_num_threads(1)


def _tk(k):
    return interop.key_to_torch(np.asarray(k), device="cpu")


def _jkey(words, impl):
    words = np.asarray(words, np.uint32)
    if impl == "rbg":
        return jax.random.wrap_key_data(words, impl="rbg")
    return jnp.asarray(words)


def _words(impl, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, 4 if impl == "rbg"
                                             else 2)
    return w.astype(np.uint32)


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


# -- creator ------------------------------------------------------------------

def test_create_specs_and_overwrite_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fmax = tcreator.create("PortFitnessMax", weights=(1.0,), note=1)
        ind = tcreator.create("PortIndividual", fitness=fmax,
                              speed=lambda k, n: tr.uniform(k, (n, 3)),
                              genome=None, smin=-1.0)
    assert isinstance(fmax, tcreator.FitnessSpec)
    assert fmax.weights == (1.0,) and fmax.nobj == 1
    assert fmax.static == {"note": 1}
    assert tcreator.PortFitnessMax is fmax
    assert set(ind.leaves) == {"speed", "genome"}
    assert ind.static == {"smin": -1.0} and ind.weights == (1.0,)
    with pytest.warns(RuntimeWarning, match="already been created"):
        tcreator.create("PortFitnessMax", weights=(-1.0,))
    with pytest.raises(TypeError):
        tcreator.create("PortBroken", smin=1.0)
    seq = tcreator.create("PortSeq", fitness=(-1.0, 1.0))
    assert seq.fitness.weights == (-1.0, 1.0)
    f = fmax.empty(4, device="cpu")
    assert f.values.shape == (4, 1) and not bool(f.valid.any())


def _jax_spec(extra: bool):
    leaves = {"speed": lambda k, n: jax.random.uniform(k, (n, 3))} \
        if extra else {}
    return jcreator.IndividualSpec(jcreator.FitnessSpec((-1.0,)), leaves)


def _torch_spec(extra: bool):
    leaves = {"speed": lambda k, n: tr.uniform(k, (n, 3))} if extra else {}
    return tcreator.IndividualSpec(tcreator.FitnessSpec((-1.0,)), leaves)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("storage", [None, "bfloat16", "int8"])
def test_init_population_against_jax(impl, storage):
    """``vmap(attr)(split(key, n))``, the narrowing and the extra leaf
    drawn after ``fold_in(key, n)``: bitwise under both keys."""
    n, dim = 33, 7
    words = _words(impl, 1)
    kw = dict(storage_dtype=storage, storage_bound=4.0)
    jspec, tspec = _jax_spec(True), _torch_spec(True)
    want = jax.jit(lambda k: jspec.init_population(
        k, n, jinit.uniform(-4.0, 4.0, (dim,)), **kw))(_jkey(words, impl))
    got = tspec.init_population(_tk(words), n,
                                tinit.uniform(-4.0, 4.0, (dim,)), **kw)
    assert set(got.genome) == {"genome", "speed"}
    jg = want.genome["genome"]
    if storage == "bfloat16":
        jg = np.asarray(jg).view(np.uint16)
        tg = got.genome["genome"].view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(jg, tg)
    else:
        assert _same(jg, got.genome["genome"])
    assert _same(want.genome["speed"], got.genome["speed"])
    assert got.fitness.values.shape == (n, 1)
    assert not bool(got.fitness.valid.any())


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_init_population_keeps_the_extra_leaf_off_row_one(impl):
    """The key is retired before the extra leaves: the first extra leaf
    does not reuse individual 1's stream."""
    words = _words(impl, 2)
    pop = _torch_spec(True).init_population(
        _tk(words), 8, tinit.uniform(0.0, 1.0, (3,)))
    leaked = tr.uniform(tr.split(_tk(words))[1], (8, 3))
    assert not torch.equal(pop.genome["speed"], leaked)
    no_extra = _torch_spec(False).init_population(
        _tk(words), 8, tinit.uniform(0.0, 1.0, (3,)))
    assert torch.equal(no_extra.genome, pop.genome["genome"])
    given = torch.zeros(8, 3)
    pop = _torch_spec(True).init_population(
        _tk(words), 8, tinit.uniform(0.0, 1.0, (3,)), speed=given)
    assert pop.genome["speed"] is given


# -- ops.init -----------------------------------------------------------------

INIT_CASES = {
    "uniform": (lambda m: m.uniform(-2.0, 3.0, (5,)), {}),
    "bernoulli": (lambda m: m.bernoulli(0.3, (9,)), {}),
    "randint": (lambda m: m.randint(-3, 4, (6,)), {}),
    "randint int8": (lambda m: m.randint(0, 200, (6,),
                                         dtype=getattr(m, "_i8")), {}),
    "permutation": (lambda m: m.permutation(11), {}),
}
jinit._i8, tinit._i8 = jnp.int8, torch.int8


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_repeat_factories_against_jax(case, impl):
    make, _ = INIT_CASES[case]
    words = _words(impl, 3)
    want = jax.jit(lambda k: jinit.init_repeat(k, make(jinit), 17))(
        _jkey(words, impl))
    got = tinit.init_repeat(_tk(words), make(tinit), 17)
    assert _same(want, got)


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_init_cycle_and_iterate_against_jax(impl):
    words = _words(impl, 4)
    jf = (jinit.uniform(0.0, 1.0, (2,)), jinit.randint(0, 9, (3,)))
    tf = (tinit.uniform(0.0, 1.0, (2,)), tinit.randint(0, 9, (3,)))
    for n in (1, 4):
        want = jax.jit(lambda k: jinit.init_cycle(k, jf, n))(
            _jkey(words, impl))
        got = tinit.init_cycle(_tk(words), tf, n)
        assert len(want) == len(got) == 2
        for a, b in zip(want, got):
            assert _same(a, b)
    want = jax.jit(lambda k: jinit.init_iterate(
        k, lambda x: x * 2.0, jinit.uniform(0.0, 1.0, (4,))))(
        _jkey(words, impl))
    got = tinit.init_iterate(_tk(words), lambda x: x * 2.0,
                             tinit.uniform(0.0, 1.0, (4,)))
    assert _same(want, got)


def test_nested_init_repeat_against_jax():
    """A population of genomes: ``init_repeat`` of ``init_repeat``."""
    words = _words("threefry2x32", 5)
    want = jax.jit(lambda k: jinit.init_repeat(
        k, lambda kk: jinit.init_repeat(kk, jinit.bernoulli(0.5), 12), 9))(
        _jkey(words, "threefry2x32"))
    got = tinit.init_repeat(_tk(words), lambda kk: tinit.init_repeat(
        kk, tinit.bernoulli(0.5), 12), 9)
    assert _same(want, got)


# -- tools --------------------------------------------------------------------

def _jax_facade_names():
    """The JAX facade's public names as a fresh interpreter sees them:
    its ``from .ops import *`` also takes every ``deap_tpu.ops`` submodule
    that was imported before it, so in this process the set would depend
    on which tests ran first."""
    import subprocess
    import sys
    code = ("import deap_tpu.tools as t; "
            "print(' '.join(n for n in dir(t) if not n.startswith('_')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    return set(out.stdout.split())


def test_tools_exports_every_name_of_the_jax_facade():
    names = _jax_facade_names()
    missing = sorted(n for n in names if not hasattr(ttools, n))
    assert missing == []
    assert ttools.selNSGA2 is ttools.emo.sel_nsga2
    assert ttools.initRepeat is tinit.init_repeat
    assert ttools.migRing is tmig.mig_ring
    for mod in ("init", "migration", "constraint", "crossover", "mutation",
                "selection", "emo", "indicator", "hv"):
        assert getattr(ttools, mod).__name__.startswith("deap_tpu_torch.ops")


# -- migration ----------------------------------------------------------------

MIGARRAYS = {"ring": None, "shifted ring": [2, 3, 0, 1],
             "non-cyclic": [3, 0, 0, 2], "reversed": [3, 2, 1, 0]}


def _islands(seed, n_isl=4, pop=16, dim=5):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (n_isl, pop, dim)).astype(np.float32)
    v = rng.integers(0, 6, (n_isl, pop, 1)).astype(np.float32)   # ties
    valid = rng.uniform(size=(n_isl, pop)) < 0.9
    return g, v, valid


@pytest.mark.parametrize("name", sorted(MIGARRAYS))
@pytest.mark.parametrize("replace", [False, True])
def test_mig_ring_stacked_against_jax(name, replace):
    """Emigrants by ``sel_best``, replacements by a tournament (repeated
    slots: the later writer wins in both), over a dict genome."""
    migarray = MIGARRAYS[name]
    g, v, valid = _islands(7)
    w = np.where(valid[..., None], v, -np.inf).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jrep = (lambda k, ww, kk: jsel.sel_tournament(k, ww, kk, 3)) \
        if replace else None
    trep = (lambda k, ww, kk: tsel.sel_tournament(k, ww, kk, 3)) \
        if replace else None
    bundle = {"genome": g, "values": v, "valid": valid}
    want, wslots = jax.jit(lambda k, b, ww: jmig.mig_ring_stacked(
        k, b, ww, 5, jsel.sel_best, jrep, migarray))(key, bundle, w)
    got, tslots = tmig.mig_ring_stacked(
        _tk(key), {k: torch.from_numpy(x) for k, x in bundle.items()},
        torch.from_numpy(w), 5, tsel.sel_best, trep, migarray)
    assert _same(wslots, tslots.to(torch.int32))
    for k in bundle:
        assert _same(want[k], got[k]), k
    if replace:
        assert (np.diff(np.sort(np.asarray(wslots), 1), axis=1) == 0).any()


def test_mig_ring_over_populations_against_jax():
    g, v, valid = _islands(8, n_isl=3)
    jpops = [jbase.Population(jnp.asarray(g[i]), jbase.Fitness(
        jnp.asarray(v[i]), jnp.asarray(valid[i]), (1.0,))) for i in range(3)]
    tpops = [tbase.Population(torch.from_numpy(g[i]), tbase.Fitness(
        torch.from_numpy(v[i]), torch.from_numpy(valid[i]), (1.0,)))
        for i in range(3)]
    key = jax.random.PRNGKey(12)
    for migarray in (None, [2, 0, 1], [1, 1, 0]):
        want = jmig.mig_ring(key, jpops, 4, jsel.sel_best,
                             lambda k, f, n: jsel.sel_random(k, f, n),
                             migarray)
        got = tmig.mig_ring(_tk(key), tpops, 4, tsel.sel_best,
                            lambda k, f, n: tsel.sel_random(k, f, n),
                            migarray)
        for a, b in zip(want, got):
            assert _same(a.genome, b.genome)
            assert _same(a.fitness.values, b.fitness.values)
            assert _same(a.fitness.valid, b.fitness.valid)


# -- checkpoint ---------------------------------------------------------------

def _ga_toolbox():
    from deap_tpu_torch import benchmarks
    from deap_tpu_torch.ops import crossover, mutation
    tb = tbase.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_gaussian, mu=0.0, sigma=0.1,
                indpb=0.05)
    tb.register("select", tsel.sel_tournament, tournsize=3,
                tie_break="rank")
    return tb


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_checkpoint_resume_of_ea_simple_is_exact(tmp_path, impl,
                                                 asynchronous):
    """``ea_simple``'s generation (``ea_step``) two generations, a
    checkpoint of (key, population, generation), two more; the load and
    two generations from it equal the undisturbed four, bit for bit."""
    from deap_tpu_torch.algorithms import ea_step, evaluate_population
    tb = _ga_toolbox()
    key = tr.PRNGKey(3, impl=impl, device="cpu")
    k_init, key = tr.split(key)
    pop = tbase.Population(tr.uniform(k_init, (64, 10), minval=-5.12,
                                      maxval=5.12),
                           tbase.Fitness.empty(64, (-1.0,), device="cpu"))
    pop, _ = evaluate_population(tb, pop)
    path = tmp_path / "run.ckpt"
    k, p = key, pop
    for gen in range(4):
        k, p, _ = ea_step(k, p, tb, 0.5, 0.2)
        if gen == 1:
            state = {"key": k, "population": p, "gen": gen + 1}
            if asynchronous:
                handle = tck.async_save_checkpoint(path, state)
            else:
                tck.save_checkpoint(path, state)
    if asynchronous:
        handle.result()
    back = tck.load_checkpoint(path, device="cpu")
    assert back["gen"] == 2 and tr.impl_of(back["key"]) == impl
    assert back["key"].dtype == torch.int64
    k2, p2 = back["key"], back["population"]
    assert isinstance(p2, tbase.Population)
    for _ in range(2):
        k2, p2, _ = ea_step(k2, p2, tb, 0.5, 0.2)
    assert torch.equal(k2, k)
    assert _same(p.genome, p2.genome)
    assert _same(p.fitness.values, p2.fitness.values)
    assert torch.equal(p.fitness.valid, p2.fitness.valid)
    assert not path.with_suffix(".ckpt.tmp").exists()


def test_checkpoint_keeps_dtypes_and_structures(tmp_path):
    from deap_tpu_torch.utils.support import Logbook
    log = Logbook()
    log.record(gen=0, best=1.5)
    state = {"bf16": torch.tensor([1.5, -2.25]).to(torch.bfloat16),
             "i8": torch.tensor([-3, 4], dtype=torch.int8),
             "tuple": (torch.arange(3), [torch.ones(2, dtype=torch.bool)]),
             "pop": tbase.Population({"x": torch.zeros(2, 3)},
                                     tbase.Fitness.empty(2, (1.0, -1.0),
                                                         device="cpu")),
             "log": log, "note": "text"}
    tck.save_checkpoint(tmp_path / "s", state)
    back = tck.load_checkpoint(tmp_path / "s", device="cpu")
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["bf16"], state["bf16"])
    assert back["i8"].dtype == torch.int8 and torch.equal(back["i8"],
                                                          state["i8"])
    assert isinstance(back["tuple"], tuple)
    assert torch.equal(back["tuple"][1][0], state["tuple"][1][0])
    assert back["pop"].fitness.weights == (1.0, -1.0)
    assert isinstance(back["log"], Logbook) and back["log"][0]["best"] == 1.5
    assert back["note"] == "text"
    # a later change to the saved tensor does not reach the checkpoint
    x = torch.zeros(4)
    handle = tck.async_save_checkpoint(tmp_path / "a", {"x": x})
    x += 1.0
    handle.result()
    assert torch.equal(tck.load_checkpoint(tmp_path / "a", device="cpu")["x"],
                       torch.zeros(4))


def test_async_save_failure_reraises_once(tmp_path, monkeypatch):
    """A writer's failure comes back from ``result()`` once; unjoined, it
    comes back from the next save to the same path, before that save
    starts; other paths are unaffected."""
    path = tmp_path / "f.ckpt"
    real = tck._write

    def boom(p, s):
        raise OSError("disk full")

    monkeypatch.setattr(tck, "_write", boom)
    h = tck.async_save_checkpoint(path, {"x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        h.result()
    h.result()                                   # reported once
    tck.async_save_checkpoint(path, {"x": torch.ones(2)}).join()
    other = tck.async_save_checkpoint(tmp_path / "other", {"x": 1})
    with pytest.raises(RuntimeError, match="was not started") as info:
        tck.async_save_checkpoint(path, {"x": torch.ones(2)})
    assert isinstance(info.value.__cause__, OSError)
    monkeypatch.setattr(tck, "_write", real)
    with pytest.raises(OSError):
        other.result()
    tck.async_save_checkpoint(path, {"x": torch.full((2,), 7.0)}).result()
    assert torch.equal(tck.load_checkpoint(path, device="cpu")["x"],
                       torch.full((2,), 7.0))


def test_overlapping_async_saves_to_one_path_serialize(tmp_path,
                                                       monkeypatch):
    """Two saves to one path never write at once; the later state wins."""
    path = tmp_path / "o.ckpt"
    real = tck._write
    active, seen = [0], []
    gate = threading.Event()

    def slow(p, s):
        active[0] += 1
        seen.append(active[0])
        gate.wait(5)
        real(p, s)
        active[0] -= 1

    monkeypatch.setattr(tck, "_write", slow)
    h1 = tck.async_save_checkpoint(path, {"v": torch.tensor(1)})
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    h2 = tck.async_save_checkpoint(str(path), {"v": torch.tensor(2)})
    h1.result()
    h2.result()
    timer.join()
    assert seen == [1, 1]
    assert int(tck.load_checkpoint(path, device="cpu")["v"]) == 2


def test_sharded_checkpoint_is_not_ported(tmp_path):
    """The sharded tier now runs (``tests/test_torch_parallel.py`` saves
    at two ranks and loads at one and four): with one writer it round
    trips a state bit for bit, bfloat16 and the key's implementation
    included, and refuses a directory it did not commit."""
    key = tr.PRNGKey(3, impl="rbg", device="cpu")
    state = {"key": key, "g": torch.arange(12.0).reshape(3, 4).to(
        torch.bfloat16), "gen": 4, "note": "x"}
    tck.save_sharded_checkpoint(tmp_path / "s", state)
    back = tck.load_sharded_checkpoint(tmp_path / "s", state)
    assert torch.equal(back["key"], key) and back["key"].shape == (4,)
    assert back["g"].dtype == torch.bfloat16
    assert torch.equal(back["g"], state["g"])
    assert (back["gen"], back["note"]) == (4, "x")
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        tck.load_sharded_checkpoint(tmp_path, {})
    assert not hasattr(tck, "ShardedNotPorted")


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    tck.save_checkpoint(tmp_path / "c", {"x": torch.zeros(1)})
    if not torch.cuda.is_available():
        from deap_tpu_torch import NoCudaDevice
        with pytest.raises(NoCudaDevice):
            tck.load_checkpoint(tmp_path / "c")


# -- compilecache -------------------------------------------------------------

def test_compile_cache_points_the_kernel_build(tmp_path, monkeypatch):
    from deap_tpu_torch.kernels import build as kb
    from deap_tpu_torch.native import build as nb
    monkeypatch.setattr(kb, "BUILD_DIR", kb.BUILD_DIR)
    monkeypatch.setattr(nb, "BUILD_DIR", nb.BUILD_DIR)
    monkeypatch.setenv(tcc.ENV_VAR, str(tmp_path / "cache"))
    assert tcc.ENV_VAR == "DEAP_TPU_COMPILE_CACHE"
    where = tcc.cache_dir_from_env()
    got = tcc.enable_compile_cache(where, min_compile_time_secs=5.0,
                                   min_entry_size_bytes=10)
    assert got == (tmp_path / "cache").resolve() and got.is_dir()
    assert kb.BUILD_DIR == got and nb.BUILD_DIR == got
    monkeypatch.setenv(tcc.ENV_VAR, "  ")
    assert tcc.cache_dir_from_env() is None
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.warns(UserWarning, match="compile cache disabled"):
        assert tcc.enable_compile_cache(blocker / "sub") is None
