"""The port's sharded NSGA-II (``deap_tpu_torch.parallel.emo_sharded``)
at R = 1, 2 and 4 gloo ranks, against the port's single-device
``nondominated_ranks`` / ``sel_nsga2``, the JAX package's single-device
functions, and its sharded functions on an R-device sub-mesh.

Everything here is integer: dominator counts, ranks, front counts and
selected indices are compared exactly.  The JAX sharded oracle is the
``indices`` peel, the grid, and the selection with both crowding tails;
its ``exchange="rows"`` peel does not trace on jax 0.9.0 (a
``while_loop`` carry typed ``int32[]{V:pop}`` against ``int32[]``,
``deap_tpu/parallel/emo_sharded.py:652``), so the port's rows exchange
is held to the single-device functions, which the JAX contract says it
equals index for index.  JAX compiles its sharded crowding tail slowly
(10–30 s a shape here), so that oracle runs on one shape."""

import os
import pathlib

import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from deap_tpu_torch import base as tbase
from deap_tpu_torch.ops import emo as temo
from deap_tpu_torch.ops.dominance import rows_dominate_counts
from deap_tpu_torch.parallel import launch

RANKS = (1, 2, 4)
TESTS = str(pathlib.Path(__file__).resolve().parent)
CASE_IDS = [f"n{n}-m{m}-k{k}-c{c}" for n, m, k, c in C.EMO_CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=TESTS)
    return {R: launch.run_ranks("_torch_dist_cases:emo_cases", R, env=env,
                                timeout=60, deadline=240, threads=2,
                                workdir=tmp_path_factory.mktemp(f"r{R}"))
            for R in RANKS}


def _jmesh(R):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:R]), ("pop",))


def _port_single(n, m, k, c):
    w = torch.from_numpy(C.mo_cloud(n + m, n, m))
    counts = rows_dominate_counts(w, w)
    ranks = {meth: temo.nondominated_ranks(w, method=meth, stop_at_k=k,
                                           front_chunk=c)
             for meth in ("peel", "grid")}
    sel = None
    if k is not None:
        fit = tbase.Fitness(-w, torch.ones(n, dtype=torch.bool), (-1.0,) * m)
        sel = temo.sel_nsga2(None, fit, k, nd="peel", front_chunk=c)
    return counts, ranks, sel


def _jax_fitness(w):
    import jax.numpy as jnp
    from deap_tpu import base
    n, m = w.shape
    return base.Fitness(values=jnp.asarray(-w), valid=jnp.ones((n,), bool),
                        weights=(-1.0,) * m)


@pytest.mark.parametrize("case", C.EMO_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("R", RANKS)
def test_sharded_counts_ranks_and_selection(ranks, R, case):
    """Every rank's gathered counts, ranks (indices and rows exchange,
    grid) and selections (both ranks engines, both tails, both
    exchanges) equal the single-device port, which equals JAX's
    single-device functions."""
    import jax
    import jax.numpy as jnp
    from deap_tpu.ops.emo import nondominated_ranks, sel_nsga2
    n, m, k, c = case
    counts, single, sel = _port_single(n, m, k, c)
    w = C.mo_cloud(n + m, n, m)
    jr, jnf = nondominated_ranks(jnp.asarray(w), method="peel", stop_at_k=k)
    assert np.array_equal(single["peel"][0].numpy(), np.asarray(jr))
    assert single["peel"][1] == int(jnf)
    assert np.array_equal(single["grid"][0].numpy(), np.asarray(jr))
    if sel is not None:
        jsel = jax.jit(lambda f: sel_nsga2(None, f, k, nd="peel"))(
            _jax_fitness(w))
        assert np.array_equal(sel.numpy(), np.asarray(jsel))
    for o in ranks[R]:
        res = o[case]
        assert torch.equal(res["counts"], counts)
        for key in (("peel", "indices"), ("peel", "rows"),
                    ("grid", "indices")):
            r, nf = res[key]
            assert torch.equal(r, single["peel"][0]), key
            assert nf == single["peel"][1], key
        if sel is not None:
            for key, got in res.items():
                if key[0] == "sel":
                    assert torch.equal(got.to(torch.int64),
                                       sel.to(torch.int64)), key


@pytest.mark.parametrize("case", C.EMO_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("R", (2, 4))
def test_sharded_ranks_match_jax_on_a_mesh(ranks, R, case):
    """The indices peel and the grid equal JAX's sharded functions on an
    R-device mesh (ranks and front count)."""
    import jax.numpy as jnp
    from deap_tpu.parallel import nondominated_ranks_sharded
    n, m, k, c = case
    w = jnp.asarray(C.mo_cloud(n + m, n, m))
    for method in ("peel", "grid"):
        jr, jnf = nondominated_ranks_sharded(w, _jmesh(R), front_chunk=c,
                                             stop_at_k=k, method=method)
        for o in ranks[R]:
            r, nf = o[case][(method, "indices")]
            assert np.array_equal(r.numpy(), np.asarray(jr)), method
            assert nf == int(jnf), method


@pytest.mark.parametrize("R", (2, 4))
def test_sharded_selection_matches_jax_on_a_mesh(ranks, R):
    """``sel_nsga2_sharded`` with the replicated tail on an R-device mesh,
    both ranks engines."""
    from deap_tpu.parallel import sel_nsga2_sharded
    case = n, m, k, c = C.EMO_CASES[0]
    fit = _jax_fitness(C.mo_cloud(n + m, n, m))
    for method in ("peel", "grid"):
        want = np.asarray(sel_nsga2_sharded(None, fit, k, _jmesh(R),
                                            front_chunk=c, ranks=method,
                                            tail="replicated"))
        for o in ranks[R]:
            for tail in ("sharded", "replicated"):
                got = o[case][("sel", method, tail, "indices")]
                assert np.array_equal(got.numpy(), want), (method, tail)


def test_sharded_crowding_tail_matches_jax_on_a_mesh(ranks):
    """The objective-split crowding tail: four objectives over four
    ranks, one objective a rank."""
    from deap_tpu.parallel import sel_nsga2_sharded
    case = n, m, k, c = C.EMO_CASES[-1]
    fit = _jax_fitness(C.mo_cloud(n + m, n, m))
    want = np.asarray(sel_nsga2_sharded(None, fit, k, _jmesh(4),
                                        front_chunk=c, tail="sharded"))
    for o in ranks[4]:
        for ex in ("indices", "rows"):
            got = o[case][("sel", "peel", "sharded", ex)]
            assert np.array_equal(got.numpy(), want), ex


def test_sharded_emo_refuses_bad_arguments():
    from deap_tpu_torch.parallel import emo_sharded as E

    class M:
        size, rank, axis_name = 2, 0, "pop"
    w = torch.zeros((4, 2))
    for fn in (E.dominance_counts_sharded, E.nondominated_ranks_sharded):
        with pytest.raises(ValueError, match="one axis is 'pop'"):
            fn(w, M, axis="island")
    with pytest.raises(ValueError, match="one axis is 'pop'"):
        E.sel_nsga2_sharded(None, w, 2, M, axis="island")
    with pytest.raises(ValueError, match="exchange"):
        E.nondominated_ranks_sharded(w, M, exchange="psum")
    with pytest.raises(ValueError, match="method"):
        E.nondominated_ranks_sharded(w, M, method="dense")
    with pytest.raises(ValueError, match="holds 4 rows"):
        E.dominance_counts_sharded(w, M, n=20)
    with pytest.raises(ValueError, match="tail"):
        E.sel_nsga2_sharded(None, w, 2, M, tail="psum")
