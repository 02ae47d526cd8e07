"""The CUDA kernels of deap_tpu_torch and their wrappers.

Tests marked ``gpu`` need a card and skip without one; run them on the
machine with the card (the file imports no JAX, and ``--noconftest``
skips the suite's JAX-based conftest):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

On the card each kernel must equal its plain version bit for bit (the
stated ulp bound is 0; the probe kernels P1–P5 too, P3's lookup
exactly), except K5, whose sums run in another order than
the plain sweep's: relative 1e-4 in float32 and 1e-11 in float64.  The CPU tests pin the wrappers' contract: CPU
tensors take the plain version and count no launch, the launchers refuse
CPU tensors, and a missing compiler raises instead of falling back.
"""

import json
import sys

import numpy as np
import pytest
import torch

from deap_tpu_torch import benchmarks, gp, kernels, random
from deap_tpu_torch.base import Fitness, Toolbox
from deap_tpu_torch.kernels import build
from deap_tpu_torch.ops import dominance as D, emo as E, generation as G
from deap_tpu_torch.ops import hv as host_hv, hypervolume as H
from deap_tpu_torch.probes import ga as PGA, gp as PGP

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

DIM = 100
KNOBS = [0.9, 0.5, 0.0, 0.3, 0.05]
STORAGES = [G.GenomeStorage("float32"), G.GenomeStorage("bfloat16"),
            G.GenomeStorage("int8", 5.12)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, pop, st):
    key = random.PRNGKey(5, device=dev)
    k_g, k_o, k_p, k_s = random.split(key, 4)
    g = st.to_storage(random.uniform(k_g, (pop, DIM), minval=-5.12,
                                     maxval=5.12))
    order = torch.argsort(random.uniform(k_o, (pop,))).to(torch.int32)
    pos = random.randint(k_p, (pop,), 0, pop)
    knobs = torch.tensor(KNOBS, dtype=torch.float32, device=dev)
    return g, order, pos, G._seed_from_key(k_s), knobs


def _same(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("st", STORAGES, ids=lambda s: s.dtype)
def test_kernels_equal_plain_versions_on_card(st):
    dev = _cuda()
    pop = 1_000_000
    g, order, pos, seed, knobs = _inputs(dev, pop, st)
    kernels.reset_launches()
    k1 = G.megakernel_vary(g, seed, knobs, dim=DIM, storage=st)
    p1 = G._narrow(G._vary_tile_plain(G._widen(g, st.dtype, st.scale), seed,
                                      knobs, DIM), st.dtype, st.scale)
    k2, w2 = G.megakernel_gather_vary(order, pos, g, seed, knobs, dim=DIM,
                                      storage=st)
    p2, pw = G._gather_vary_plain(order, pos, g, seed, knobs, DIM, st)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"megakernel_vary": 1,
                                "megakernel_gather_vary": 1,
                                "megakernel_var_or": 0,
                                "rows_dominate_counts": 0,
                                "gp_interp": 0, "hv3d_sweep": 0,
                                "probe_stream_copy": 0, "probe_chain24": 0,
                                "probe_rast_reduce": 0,
                                "probe_hash_normal": 0, "probe_lookup": 0,
                                "probe_row_gather": 0, "probe_gp": 0}
    assert _same(k1, p1) and _same(k2, p2) and torch.equal(w2, pw)


@pytest.mark.gpu
@pytest.mark.parametrize("st", STORAGES, ids=lambda s: s.dtype)
@pytest.mark.parametrize("dim", [1, 3, 12, 100, 1000])
def test_k2_pair_layout_equals_plain_on_card(st, dim):
    """K2 (one warp a mating pair, vector accesses as wide as the row
    pitch and the base addresses allow) against its plain version, bit
    for bit, with ``widx`` equal: 32 output rows, and 4096 rows from a
    genome view one row past its allocation (bfloat16 and int8 rows at
    odd dims are then not even 4-byte aligned) at ``row_base0`` not a
    multiple of 32."""
    dev = _cuda()
    key = random.PRNGKey(dim, device=dev)
    k_g, k_o, k_p, k_s = random.split(key, 4)
    pop = 3001
    full = st.to_storage(random.uniform(k_g, (pop + 1, dim), minval=-5.12,
                                        maxval=5.12))
    knobs = torch.tensor(KNOBS, dtype=torch.float32, device=dev)
    seed = G._seed_from_key(k_s)
    order = torch.argsort(random.uniform(k_o, (pop,))).to(torch.int32)
    for g, out_n, row_base0 in ((full[:pop], 32, 0), (full[1:], 4096, 229),
                                (full[1:], 4096, 1 << 20)):
        pos = random.randint(random.fold_in(k_p, out_n + row_base0),
                             (out_n,), 0, pop)
        kernels.reset_launches()
        k2, w2 = G.megakernel_gather_vary(order, pos, g, seed, knobs,
                                          dim=dim, storage=st,
                                          row_base0=row_base0)
        p2, pw = G._gather_vary_plain(order, pos, g, seed, knobs, dim, st,
                                      row_base0)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["megakernel_gather_vary"] == 1
        assert _same(k2, p2) and torch.equal(w2, pw)


@pytest.mark.gpu
@pytest.mark.parametrize("st", STORAGES, ids=lambda s: s.dtype)
@pytest.mark.parametrize("dim", [1, 3, 12, 100, 1000])
def test_k1_pair_layout_equals_plain_on_card(st, dim):
    """K1 (K2's pair layout without the index pass: several pairs a warp
    when a row has at most 16 vectors) against its plain version, bit
    for bit: 32 rows, and 4096 rows from a genome view one row past its
    allocation at ``row_base0`` 229 and 2**20."""
    dev = _cuda()
    key = random.PRNGKey(100 + dim, device=dev)
    k_g, k_s = random.split(key)
    full = st.to_storage(random.uniform(k_g, (4097, dim), minval=-5.12,
                                        maxval=5.12))
    knobs = torch.tensor(KNOBS, dtype=torch.float32, device=dev)
    seed = G._seed_from_key(k_s)
    for g, row_base0 in ((full[:32], 0), (full[1:], 229),
                         (full[1:], 1 << 20)):
        kernels.reset_launches()
        k1 = G.megakernel_vary(g, seed, knobs, dim=dim, storage=st,
                               row_base0=row_base0)
        p1 = G._narrow(G._vary_tile_plain(G._widen(g, st.dtype, st.scale),
                                          seed, knobs, dim, row_base0),
                       st.dtype, st.scale)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["megakernel_vary"] == 1
        assert _same(k1, p1)


@pytest.mark.gpu
@pytest.mark.parametrize("st", [G.GenomeStorage("float32"),
                                G.GenomeStorage("bfloat16"),
                                G.GenomeStorage("int8", 1.0)],
                         ids=lambda s: s.dtype)
def test_k1_at_the_nsga2_head_shape_equals_plain_on_card(st):
    """K1 at the NSGA-II head's 1e5 x 12 and knobs (several pairs a
    warp), bit for bit."""
    dev = _cuda()
    k_g, k_s = random.split(random.PRNGKey(12, device=dev))
    g = st.to_storage(random.uniform(k_g, (100_000, 12)))
    knobs = torch.tensor([0.6, 0.3, 0.0, 0.1, 1.0 / 12], dtype=torch.float32,
                         device=dev)
    seed = G._seed_from_key(k_s)
    k1 = G.megakernel_vary(g, seed, knobs, dim=12, storage=st)
    p1 = G._narrow(G._vary_tile_plain(G._widen(g, st.dtype, st.scale), seed,
                                      knobs, 12), st.dtype, st.scale)
    torch.cuda.synchronize()
    assert _same(k1, p1)


@pytest.mark.gpu
@pytest.mark.parametrize("gather", ["dma", "host"])
def test_generation_on_card_equals_cpu(gather):
    dev = _cuda()
    st = G.GenomeStorage()
    g, _, _, _, _ = _inputs(dev, 1024, st)
    w = -(g * g).sum(1, keepdim=True)
    k_sel, k_var = random.split(random.PRNGKey(8, device=dev))
    outs = [G.fused_generation(k_sel.to(d), k_var.to(d), g.to(d), w.to(d),
                               dim=DIM, cxpb=0.9, mutpb=0.5, gather=gather)
            for d in (dev, "cpu")]
    assert _same(outs[0][0].cpu(), outs[1][0])
    assert torch.equal(outs[0][1].cpu().long(), outs[1][1].long())


def _var_or_inputs(dev, n, lam, st, dim=DIM):
    key = random.PRNGKey(6, device=dev)
    k_g, k_a, k_b, k_c, k_s = random.split(key, 5)
    g = st.to_storage(random.uniform(k_g, (n, dim), minval=-5.12,
                                     maxval=5.12))
    ia = random.randint(k_a, (lam,), 0, n)
    i2 = random.randint(k_b, (lam,), 0, n)
    code = random.randint(k_c, (lam,), 0, 3)
    knobs = torch.tensor([0.0, 0.1, 1.0 / 12], device=dev)
    return g, ia, i2, code, G._seed_from_key(k_s), knobs


def _dtlz2_w(dev, n, seed=7):
    x = random.uniform(random.PRNGKey(seed, device=dev), (n, 12))
    return -torch.stack(benchmarks.dtlz2(x, 3), 1)


@pytest.mark.gpu
@pytest.mark.parametrize("st", STORAGES, ids=lambda s: s.dtype)
@pytest.mark.parametrize("shape", [(100_000, 100_000, 12),
                                   (1_000_000, 1_000_000, DIM),
                                   (100_000, 123_457, 1),
                                   (100_000, 65_537, 3),
                                   (100_000, 77_777, 12),
                                   (100_000, 54_321, DIM),
                                   (20_000, 30_011, 1000)])
def test_var_or_kernel_equals_plain_on_card(st, shape):
    dev = _cuda()
    n, lam, dim = shape
    g, ia, i2, code, seed, knobs = _var_or_inputs(dev, n, lam, st, dim)
    kernels.reset_launches()
    k3 = G.megakernel_var_or(g, ia, i2, code, seed, knobs, dim=dim,
                             storage=st)
    p3 = G._var_or_plain(g, ia, i2, code, seed, knobs, dim, st)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["megakernel_var_or"] == 1
    assert _same(k3, p3)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1024, 200_000])
def test_dominance_kernel_equals_plain_on_card(C):
    dev = _cuda()
    w = _dtlz2_w(dev, 200_000)
    w[:64] = w[64:128]                                  # duplicated points
    rows = w[:C].clone()
    rows[::7] = float("-inf")                           # sentinel rows
    kernels.reset_launches()
    k4 = D.rows_dominate_counts(rows, w)
    p4 = D._rows_dominate_counts_plain(rows, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rows_dominate_counts"] == 1
    assert torch.equal(k4, p4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 3, 5, 9])
def test_dominance_kernel_any_width_on_card(m):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m)
    w = torch.randint(0, 4, (3001, m), generator=gen, device=dev).float()
    rows = w[:333].contiguous()
    assert torch.equal(D.rows_dominate_counts(rows, w),
                       D._rows_dominate_counts_plain(rows, w))


@pytest.mark.gpu
def test_sel_nsga2_on_card_equals_cpu():
    dev = _cuda()
    values = -_dtlz2_w(dev, 2048, seed=3)
    out = []
    for d in (dev, "cpu"):
        f = Fitness(values=values.to(d),
                    valid=torch.ones(2048, dtype=torch.bool, device=d),
                    weights=(-1.0,) * 3)
        out.append(E.sel_nsga2(None, f, 1024, nd="peel", front_chunk=256))
    assert torch.equal(out[0].cpu(), out[1])


@pytest.mark.gpu
def test_spea2_strength_on_card_with_inf_rows():
    """SPEA2's strength through K4 with the roles swapped: ``-w`` rows,
    where the masked ``-inf`` rows become ``+inf``, equal the plain
    version's counts."""
    dev = _cuda()
    w = _dtlz2_w(dev, 20_000, seed=11)
    w[:64] = w[64:128]
    w[::13] = float("-inf")
    nw = (-w).contiguous()
    kernels.reset_launches()
    k4 = D.rows_dominate_counts(nw, nw)
    p4 = D._rows_dominate_counts_plain(nw, nw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rows_dominate_counts"] == 1
    assert torch.equal(k4, p4)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_permutation_on_card_equals_cpu(impl, n):
    dev = _cuda()
    key = random.PRNGKey(n, impl=impl, device="cpu")
    assert torch.equal(random.permutation(key.to(dev), n).cpu(),
                       random.permutation(key, n))


@pytest.mark.gpu
def test_nsga3_and_spea2_on_card_equal_cpu():
    dev = _cuda()
    values = -_dtlz2_w(dev, 2048, seed=5)
    rp = E.uniform_reference_points(3, 12)
    out = []
    for d in (dev, "cpu"):
        f = Fitness(values=values.to(d),
                    valid=torch.ones(2048, dtype=torch.bool, device=d),
                    weights=(-1.0,) * 3)
        key = random.PRNGKey(3, device=d)
        out.append((E.sel_nsga3(key, f, 1024, rp).cpu(),
                    E.sel_spea2(key, f, 1024, chunk=500).cpu(),
                    E.sel_spea2_staged(key, f, 1024, chunk=500).cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _gp_pset(which):
    """The bench's primitive set, or one with every opcode of K6's table
    (all of ``safe_ops`` and ``bool_ops``, two arguments, a terminal)."""
    if which == "bench":
        ps = gp.PrimitiveSet("MAIN", 1)
        ops = {k: gp.safe_ops[k] for k in ("add", "sub", "mul", "div", "neg",
                                           "cos", "sin")}
    else:
        ps = gp.PrimitiveSet("ALL", 2)
        ops = {**gp.safe_ops, **gp.bool_ops}
        ps.add_terminal(1.0, name="one")
    for name, (f, a) in ops.items():
        ps.add_primitive(f, a, name=name)
    ps.add_ephemeral_constant(
        "rand101", lambda keys: random.randint(keys, (), -1, 2).float())
    return ps


def _nan_equal(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["bench", "all"])
@pytest.mark.parametrize("skip", [False, True], ids=["all_rows", "skipped"])
def test_gp_interp_kernel_equals_plain_on_card(which, skip):
    dev = _cuda()
    ps, cap, pop = _gp_pset(which), 64, 4096
    keys = random.split(random.PRNGKey(3, device=dev), pop)
    codes, consts, lengths = gp.make_generator(ps, cap, "half_and_half")(
        keys, 2, 6)
    if skip:
        lengths = torch.where(torch.arange(pop, device=dev) % 2 == 0, 0,
                              lengths)
    n_args = len(ps.arguments)
    X = torch.stack([torch.linspace(-1, 1, 1024, device=dev) * (i + 1)
                     for i in range(n_args)])
    ev = gp.make_population_evaluator(ps, cap)
    kernels.reset_launches()
    k6 = ev(codes, consts, lengths, X)
    plain = gp.run_stack_machine(codes, consts, lengths, X, ps.freeze(), cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gp_interp"] == 1 and ev.last_backend == "cuda"
    assert _nan_equal(k6, plain)
    if skip:
        assert (k6[::2] == 0).all()


def _gp_edge_inputs(dev, case):
    """chip_smoke.py's K6 edges: comb trees of exactly 64 tokens (the
    deepest stack, ``if`` at depth) at 1024, 1, 1000 and 4097 points,
    deep bench trees at 4097 points, a single tree, every row skipped;
    ``_capN``: comb trees of exactly N tokens, where a block holds fewer
    warps (6 at cap 256, 3 at cap 447; at 4097 points ``X`` is not
    staged)."""
    from deap_tpu_torch.probes.gp import comb_trees
    pop, cap = 4096, 64
    kind, _, n = case.partition("_")
    if n.startswith("cap"):
        c, _, n = n[3:].partition("_")
        cap = int(c)
    n = int(n) if n.isdigit() else 1024
    ps = _gp_pset("all" if kind == "comb" else "bench")
    if kind == "comb":
        codes, consts, lengths = comb_trees(ps, np.random.default_rng(8),
                                            pop, cap, dev)
    else:
        keys = random.split(random.PRNGKey(4, device=dev), pop)
        codes, consts, lengths = gp.make_generator(ps, cap, "half_and_half")(
            keys, 2, 6)
    if kind == "single":
        codes, consts, lengths = codes[:1], consts[:1], lengths[:1]
    if kind == "skipped":
        lengths = torch.zeros_like(lengths)
    X = torch.stack([torch.linspace(-1, 1, n, device=dev) * (i + 1)
                     for i in range(len(ps.arguments))])
    return ps, cap, (codes, consts, lengths), X


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["comb", "comb_1", "comb_1000", "comb_4097",
                                  "deep_4097", "single", "skipped",
                                  "comb_cap128", "comb_cap256",
                                  "comb_cap256_4097", "comb_cap447"])
def test_gp_interp_kernel_edges_on_card(case):
    dev = _cuda()
    ps, cap, trees, X = _gp_edge_inputs(dev, case)
    kernels.reset_launches()
    k6 = gp.make_population_evaluator(ps, cap, backend="cuda")(*trees, X)
    plain = gp.run_stack_machine(*trees, X, ps.freeze(), cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gp_interp"] == 1
    assert k6.shape == (trees[0].shape[0], X.shape[1])
    assert _nan_equal(k6, plain)
    if case == "skipped":
        assert (k6 == 0).all()


def _gp_children(dev, op, pop=4096, cap=64):
    """A bench-set population (with ``lf`` for the semantic operators) and
    its children under ``op``, from fixed keys on ``dev``."""
    ps = PGP.bench_pset(semantic=op != "mut_insert")
    keys = random.split(random.PRNGKey(6, device=dev), pop)
    trees = gp.make_generator(ps, cap, "half_and_half")(keys, 1, 4)
    if op == "cx_semantic":
        h = pop // 2
        k = random.split(random.PRNGKey(7, device=dev), h)
        a, b = gp.cx_semantic(k, tuple(t[:h] for t in trees),
                              tuple(t[h:] for t in trees), ps)
        kids = tuple(torch.cat([x, y]) for x, y in zip(a, b))
    else:
        k = random.split(random.PRNGKey(7, device=dev), pop)
        kids = getattr(gp, op)(k, trees, ps)
    return ps, kids


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["mut_insert", "mut_semantic", "cx_semantic"])
def test_gp_interp_kernel_on_new_operator_children_on_card(op):
    """K6 on inserted trees and on semantic children (``lf`` around
    random trees, rows at the capacity), bitwise to the plain
    interpreter; the children themselves equal the CPU's."""
    dev = _cuda()
    ps, kids = _gp_children(dev, op)
    _, host = _gp_children(torch.device("cpu"), op)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(kids, host))
    X = torch.linspace(-1, 1, 1024, device=dev)[None, :]
    kernels.reset_launches()
    k6 = gp.make_population_evaluator(ps, 64, backend="cuda")(*kids, X)
    plain = gp.run_stack_machine(*kids, X, ps.freeze(), 64)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gp_interp"] == 1
    assert _nan_equal(k6, plain)
    if op != "mut_insert":
        lf = ps.freeze().names.index("lf")
        assert bool((kids[0] == lf).any())


@pytest.mark.gpu
def test_harm_generation_on_card_equals_cpu():
    """One HARM generation (pop 256, 2000 natural children) on the bench
    toolbox from the same evaluated population and key: the card's
    trees equal the CPU's, the fitness within 1e-5 (the MSE's mean
    reduces in another order)."""
    dev, cpu = _cuda(), torch.device("cpu")
    outs = []
    pop_c = None
    for d in (cpu, dev):
        ps, tb, _, gen, _ = PGP.bench_toolbox(d, n_points=256)
        if pop_c is None:
            pop_c = PGP.bench_initial(tb, gen, random.PRNGKey(8, device=cpu),
                                      256)
        pop = type(pop_c)(tuple(g.to(d) for g in pop_c.genome),
                          Fitness(pop_c.fitness.values.to(d),
                                  pop_c.fitness.valid.to(d),
                                  pop_c.fitness.weights))
        out, _ = gp.harm(random.PRNGKey(9, device=d), pop, tb, 0.5, 0.1, 1,
                         mincutoff=10)
        outs.append(out)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(outs[0].genome,
                                                       outs[1].genome))
    torch.testing.assert_close(outs[1].fitness.values.cpu(),
                               outs[0].fitness.values, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_lexicase_selections_on_card_equal_cpu():
    from deap_tpu_torch.ops import selection as S
    dev = _cuda()
    rng = np.random.default_rng(2)
    cases = -torch.from_numpy(rng.integers(0, 5, (300, 64)).astype(
        np.float32) + rng.random((300, 64)).astype(np.float32) * 0.01)
    key = random.PRNGKey(4, device="cpu")
    for f in (lambda k, c: S.sel_lexicase(k, c, 300),
              lambda k, c: S.sel_epsilon_lexicase(k, c, 300, 0.5),
              lambda k, c: S.sel_automatic_epsilon_lexicase(k, c, 300)):
        assert torch.equal(f(key.to(dev), cases.to(dev)).cpu(),
                           f(key, cases))


@pytest.mark.gpu
def test_routine_cuda_graph_on_card_equals_cpu():
    """The ant's routines run as replayed CUDA graphs on the card, the
    eager loop on the CPU: the same final states."""
    from deap_tpu_torch.examples.gp import ant
    dev = _cuda()
    ps = ant.build_pset()
    keys = random.split(random.PRNGKey(2, device="cpu"), 64)
    trees = gp.make_generator(ps, ant.CAP, "half_and_half")(keys, 1, 5)
    ev = ant.make_evaluate(ps)
    host = ev(trees)[0]
    card = ev(tuple(t.to(dev) for t in trees))[0]
    assert torch.equal(card.cpu(), host)


def test_cpu_tensors_take_the_plain_version():
    st = G.GenomeStorage()
    g, order, pos, seed, knobs = _inputs("cpu", 256, st)
    kernels.reset_launches()
    out = G.megakernel_vary(g, seed, knobs, dim=DIM, storage=st)
    new, widx = G.megakernel_gather_vary(order, pos, g, seed, knobs,
                                         dim=DIM, storage=st)
    assert not any(kernels.LAUNCHES.values())
    assert out.shape == new.shape == (256, DIM)
    assert torch.equal(widx, order[pos.long()])


def test_launchers_refuse_cpu_tensors_before_building():
    st = G.GenomeStorage()
    g, order, pos, seed, knobs = _inputs("cpu", 64, st)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_vary(g, seed, knobs, dim=DIM, dtype="float32",
                            scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_gather_vary(order, pos, g, seed, knobs, dim=DIM,
                                   dtype="float32", scale=1.0)
    _, ia, i2, code, _, k3 = _var_or_inputs("cpu", 64, 32, st)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_var_or(g, ia, i2, code, seed, k3, dim=DIM,
                              dtype="float32", scale=1.0)
    w = torch.zeros((16, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_rows_dominate_counts(w, w)
    with pytest.raises(ValueError, match="CUDA"):
        kernels._cos_reduced_mismatches(0, 16, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-11)],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 33, 127, 1025, 8192])
def test_k5_equals_plain_on_card(n, dtype, rtol):
    """K5 against the plain sweep on the card: the total and every slab
    partial within the stated bound, two launches bitwise equal (total
    and partials), one launch per hypervolume."""
    dev = _cuda()
    p = random.uniform(random.PRNGKey(n, device=dev), (n, 3), maxval=1.2)
    p[::5] = p[0].clone()                               # duplicates
    pts = p.to(dtype)
    ref = [1.0, 1.1, 0.9]
    kernels.reset_launches()
    got = H.hypervolume_3d_cuda(pts, ref)
    again = H.hypervolume_3d_cuda(pts, ref)
    assert kernels.LAUNCHES["hv3d_sweep"] == 2
    want = H.hypervolume_3d(pts, ref)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got.reshape(1).view(torch.uint8),
                       again.reshape(1).view(torch.uint8))
    assert float(got) == pytest.approx(float(want), rel=rtol)
    clipped, r = H._as_points(pts, ref)
    parts = H._hv3d_cuda_partials(clipped, r, float(r[1]), 128)
    parts2 = H._hv3d_cuda_partials(clipped, r, float(r[1]), 128)
    plain_parts = H._slab_volumes(pts, ref, 128)
    assert torch.equal(parts.view(torch.uint8), parts2.view(torch.uint8))
    assert float((parts - plain_parts).abs().max()) <= rtol * float(want)


@pytest.mark.gpu
def test_router_runs_k5_in_float64_on_card():
    dev = _cuda()
    pts = random.uniform(random.PRNGKey(5, device=dev), (300, 3))
    kernels.reset_launches()
    got = Toolbox().hypervolume(pts, [1.1] * 3)
    assert kernels.LAUNCHES["hv3d_sweep"] == 1
    assert got == pytest.approx(host_hv.hypervolume(pts, [1.1] * 3),
                                abs=1e-12)


def test_k5_chunks_fill_the_card_and_stay_long():
    """The j range splits only where the prefix groups alone would not
    give each SM its warps, and never into chunks under 256 slots."""
    assert [kernels.hv3d_chunks(n, 132) for n in (1, 2, 127, 300)] == [1] * 4
    for n in (1, 2, 127, 8192, 100_000, 200_000, 10 ** 6):
        c = kernels.hv3d_chunks(n, 132)
        groups = -(-n // kernels.HV3D_GROUP)
        assert 1 <= c <= max(1, n // kernels.HV3D_MIN_CHUNK)
        assert (c == n // kernels.HV3D_MIN_CHUNK or c == 1
                or groups * c >= kernels.HV3D_WARPS_PER_SM * 132)
    assert kernels.hv3d_chunks(8192, 132) > 1
    assert kernels.hv3d_chunks(10 ** 6, 132) == 1


def test_cpu_var_or_and_counts_take_the_plain_version():
    st = G.GenomeStorage()
    g, ia, i2, code, seed, knobs = _var_or_inputs("cpu", 64, 96, st)
    kernels.reset_launches()
    out = G.megakernel_var_or(g, ia, i2, code, seed, knobs, dim=DIM,
                              storage=st)
    w = torch.randn(50, 3)
    counts = D.rows_dominate_counts(w[:7], w)
    assert kernels.LAUNCHES["megakernel_var_or"] == 0
    assert kernels.LAUNCHES["rows_dominate_counts"] == 0
    assert out.shape == (96, DIM) and counts.shape == (50,)
    copy = code == 2
    assert torch.equal(out[copy], g[ia[copy].long()])


def test_build_digest_covers_every_source_and_flag(monkeypatch, tmp_path):
    """The library's name changes when either source or the flags do."""
    srcs = []
    for src in build.SOURCES:
        copy = tmp_path / src.name
        copy.write_bytes(src.read_bytes())
        srcs.append(copy)
    base = build.digest(srcs)
    assert base == build.digest(srcs)
    for copy in srcs:
        old = copy.read_bytes()
        copy.write_bytes(old + b"\n// edit\n")
        assert build.digest(srcs) != base
        copy.write_bytes(old)
    assert build.digest(srcs) == base
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.digest(srcs) != base
    assert [s.name for s in build.SOURCES] == ["megakernel.cu",
                                               "dominance.cu",
                                               "gp_interp.cu",
                                               "hypervolume.cu",
                                               "probes.cu"]
    # the shared header is part of the library's name too
    header = tmp_path / "device_math.cuh"
    header.write_bytes(build.HEADERS[0].read_bytes())
    with_header = build.digest(srcs + [header])
    header.write_bytes(header.read_bytes() + b"\n// edit\n")
    assert build.digest(srcs + [header]) != with_header
    assert [h.name for h in build.HEADERS] == ["device_math.cuh"]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def _fake_nvcc(tmp_path, body: str):
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport json, sys\n{body}\n")
    script.chmod(0o755)
    return str(script)


def test_build_is_one_compiler_call_over_every_source(monkeypatch,
                                                      tmp_path):
    """Every source goes to one nvcc call that writes one library, named
    by the digest; a second build reuses it without calling nvcc again."""
    log = tmp_path / "calls.jsonl"
    nvcc = _fake_nvcc(tmp_path, (
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')"))
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    lib = build.build()
    assert lib.name == f"libdeap_kernels-{build.digest()}.so"
    assert lib.read_bytes() == b"lib"
    assert build.build() == lib
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(calls) == 1
    assert "-shared" in calls[0]
    assert calls[0][-len(build.SOURCES):] == [str(s) for s in build.SOURCES]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        lib.name]


def test_compile_error_raises_and_leaves_no_library(monkeypatch, tmp_path):
    nvcc = _fake_nvcc(tmp_path, (
        "print('dominance.cu(1): error: expected a declaration')\n"
        "sys.exit(2)"))
    monkeypatch.setattr(build, "nvcc_path", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError,
                       match="expected a declaration"):
        build.build()
    assert not any((tmp_path / "build").iterdir())


_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_127rows_dominate_counts_kernelILi3EEEvPKfS2_Pixxii
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x000 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS R4, [R2] ;
        /*0030*/                   FSETP.GE.AND P0, PT, R4, R5, PT ;
        /*0040*/                   FSETP.GT.AND P1, PT, R4, R5, PT ;
        /*0050*/              @P0 IADD3 R6, R6, 0x1, RZ ;
        /*0060*/              @!P2 BRA 0x20 ;
        /*0070*/                   ISETP.GE.AND P3, PT, R7, R8, PT ;
        /*0080*/              @!P3 BRA 0x10 ;
        /*0090*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_114var_or_kernelEv
        /*0000*/                   EXIT ;
"""


def test_kernel_times_ablations_each_edit_one_source_line():
    """Every part ``kernel_times.py --ablate`` switches off names text
    that its kernel's source holds exactly once."""
    from deap_tpu_torch.kernels import kernel_times as KT
    here = build.SOURCES[0].parent
    for source, table in KT.ABLATIONS.values():
        text = (here / source).read_text()
        for name, edits in table:
            for old, new in edits:
                assert text.count(old) == 1, (source, name, old)
                assert old != new


def test_sass_finds_the_innermost_compare_loop():
    from deap_tpu_torch.kernels import sass
    funcs = sass.functions(_SASS)
    assert len(funcs) == 2
    name = next(k for k in funcs if "rows_dominate_counts_kernelILi3E" in k)
    assert [i[1] for i in funcs[name]][:3] == [
        "LDC", "BAR.SYNC.DEFER_BLOCKING", "LDS"]
    loop = sass.inner_loop(funcs[name])
    assert [i[1] for i in loop] == [
        "LDS", "FSETP.GE.AND", "FSETP.GT.AND", "IADD3", "BRA"]
    assert [i[3] for i in loop] == ["", "", "", "@P0", "@!P2"]
    assert sass.inner_loop(
        funcs["_ZN12_GLOBAL__N_114var_or_kernelEv"]) is None
    rep = sass.report("K4", funcs)
    assert rep["pairs_per_iteration"] == 2 / 6
    assert rep["loop_instructions"] == 5


_SASS_P5 = """
		Function : _ZN12_GLOBAL__N_115probe_gp_kernelILi1ELb0EEEvPKiPKfS2_Pfxiiii
        /*0000*/                   ISETP.GT.AND P0, PT, R4, 0x3, PT ;
        /*0010*/              @P0 BRA 0x40 ;
        /*0020*/                   FFMA R5, R5, 1.0000001192092895508, R6 ;
        /*0030*/                   BRA 0x60 ;
        /*0040*/                   FFMA R5, R5, 1.0000002384185791016, R6 ;
        /*0050*/                   FSEL R7, R5, R6, P0 ;
        /*0060*/                   BRX R8 -0x70 ;
        /*0070*/                   EXIT ;
"""


def test_sass_reads_how_p5_compiled_its_switch():
    from deap_tpu_torch.kernels import sass
    rep = sass.dispatch_report("P5_dispatch", sass.functions(_SASS_P5))
    assert rep["branches"] == 3 and rep["indexed_branches"] == 1
    assert rep["selects"] == 1 and rep["ffma"] == 2
    assert rep["ffma_scales"] == ["1.0000001192092895508",
                                  "1.0000002384185791016"]


_SASS_P5_STACKRW = """
		Function : _ZN12_GLOBAL__N_115probe_gp_kernelILi2ELb0EEEvPKiPKfS2_Pfxiiii
        /*0000*/                   LDC R22, c[0x2][R44] ;
        /*0010*/                   BRX R22 -0x20 ;
        /*0020*/                   LDS R40, [R30+0x400] ;
        /*0030*/                   LDS R43, [R30+0x480] ;
        /*0040*/                   FFMA R5, R5, 1.0000002384185791016, R40 ;
        /*0050*/                   FFMA R4, R4, 1.0000002384185791016, R43 ;
        /*0060*/                   FADD R5, R5, R32 ;
        /*0070*/                   FADD R4, R4, R32 ;
        /*0080*/                   BRA 0x100 ;
        /*0090*/                   STS [R30+0x400], R5 ;
        /*00a0*/                   STS [R30+0x480], R4 ;
        /*00b0*/                   FFMA R5, R5, 1.0000001192092895508, R32 ;
        /*00c0*/                   FFMA R4, R4, 1.0000001192092895508, R32 ;
        /*00d0*/                   BRA 0x100 ;
        /*00e0*/                   FFMA R5, R5, 1, R32 ;
        /*00f0*/                   FFMA R4, R4, 1, R32 ;
        /*0100*/                   BSYNC B3 ;
        /*0110*/                   FFMA R6, R6, 2, R7 ;
        /*0120*/                   EXIT ;
"""


def test_sass_counts_p5s_case_bodies_by_shape():
    """Blocks cut at control instructions and branch targets; a body is a
    block with an FFMA by a branch scale (1 counts: branch 0)."""
    from deap_tpu_torch.kernels import sass
    funcs = sass.functions(_SASS_P5_STACKRW)
    bodies = sass.case_bodies(next(iter(funcs.values())))
    assert [b["scales"] for b in bodies] == [
        ["1.0000002384185791016"], ["1.0000001192092895508"], ["1"]]
    rep = sass.dispatch_report("P5_stackrw", funcs)
    assert rep["case_bodies"] == 3 and rep["indexed_branches"] == 1
    assert rep["body_shapes"] == [
        {"ffma": 2, "fadd": 0, "lds": 0, "sts": 0, "bodies": 1},
        {"ffma": 2, "fadd": 0, "lds": 0, "sts": 2, "bodies": 1},
        {"ffma": 2, "fadd": 2, "lds": 2, "sts": 0, "bodies": 1}]


_SASS_P2 = """
		Function : _ZN12_GLOBAL__N_118hash_normal_kernelEPKiP6float4x
        /*0000*/                   S2R R2, SR_TID.X ;
        /*0010*/                   F2F.F64.F32 R4, R3 ;
        /*0020*/                   DMUL R6, R4, c[0x3][0x0] ;
        /*0030*/                   F2I.F64.TRUNC R8, R6 ;
        /*0040*/                   DADD R6, R4, -R6 ;
        /*0050*/                   FSEL R9, R8, R3, P0 ;
        /*0060*/                   I2FP.F32.U32 R10, R9 ;
        /*0070*/              @!P1 CALL.REL.NOINC 0x200 ;
        /*0080*/                   F2F.F32.F64 R11, R6 ;
        /*0090*/                   STG.E.128 desc[UR4][R12.64], R8 ;
        /*00a0*/                   STG.E.128 desc[UR4][R14.64], R8 ;
        /*00b0*/              @!P0 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_counts_p2_per_element():
    """Eight elements a pass (two 16-byte stores): each count over 8."""
    from deap_tpu_torch.kernels import sass
    rep = sass.normals_report("P2", sass.functions(_SASS_P2),
                              regs={next(iter(sass.functions(_SASS_P2))): 32})
    assert rep["elements_per_iteration"] == 8 and rep["registers"] == 32
    assert rep["per_element"] == {
        "float64": 2 / 8, "conversions": 4 / 8, "selects": 1 / 8,
        "branches": 2 / 8, "calls": 1 / 8, "all": 11 / 8}


_SASS_P1_REDUCE = """
		Function : _ZN12_GLOBAL__N_111rast_kernelEPK6float4Pfxi
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   VOTE.ALL P0, PT, P1 ;
        /*0020*/              @!P0 CALL.REL.NOINC 0x100 ;
        /*0030*/                   F2F.F64.F32 R8, R4 ;
        /*0040*/                   DMUL R10, R8, c[0x3][0x0] ;
        /*0050*/                   DFMA R10, R8, R10, R12 ;
        /*0060*/                   F2F.F32.F64 R6, R10 ;
        /*0070*/                   STS.128 [R20], R4 ;
        /*0080*/                   STS.128 [R20+0x10], R8 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/              @P2 EXIT ;
        /*00b0*/                   EXIT ;
        /*0100*/                   DMUL R10, R8, R10 ;
        /*0110*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_sass_counts_the_reduce_per_term():
    """No loop (a block a tile): the body up to the first unguarded EXIT,
    two 16-byte shared stores, eight terms; the general cosine's call
    counts as a branch and its body, past the EXIT, not at all."""
    from deap_tpu_torch.kernels import sass
    funcs = sass.functions(_SASS_P1_REDUCE)
    rep = sass.normals_report("P1_reduce", funcs)
    assert rep["elements_per_iteration"] == 8
    assert rep["per_element"] == {
        "float64": 2 / 8, "conversions": 2 / 8, "selects": 0,
        "branches": 1 / 8, "calls": 1 / 8, "all": 12 / 8}


_SASS_P3 = """
		Function : _ZN12_GLOBAL__N_113lookup_kernelEPKiS1_Pix
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   LDG.E.64 R6, desc[UR4][R16.64] ;
        /*0020*/                   IMAD.WIDE R12, R4, 0x4, R14 ;
        /*0030*/                   LDG.E.CONSTANT R8, desc[UR4][R12.64] ;
        /*0040*/                   IMAD.WIDE R18, R7, 0x4, R14 ;
        /*0050*/                   LDG.E.CONSTANT R9, desc[UR4][R18.64] ;
        /*0060*/                   STG.E desc[UR4][R22.64], R8 ;
        /*0070*/                   STG.E desc[UR4][R24.64], R9 ;
        /*0080*/              @P0 BRA 0x0 ;
        /*0090*/                   EXIT ;
"""


def test_sass_counts_the_lookups_reads_in_flight():
    """Two loads of positions are issued before an instruction reads one
    of their registers (the IMAD.WIDE reads R4; R7 is the second half of
    the 8-byte load); the table reads come after."""
    from deap_tpu_torch.kernels import sass
    rep = sass.lookup_report("P3", sass.functions(_SASS_P3))
    assert rep["loads_by_bytes"] == {4: 3, 8: 1}
    assert rep["stores"] == 2 and rep["loads_in_flight"] == 2
    assert rep["loop_instructions"] == 9


def _cos_reduced(y):
    """``cos_reduced`` of ``kernels/device_math.cuh`` transcribed: the
    float64 steps one rounding each, both polynomials on the reduced
    argument, the signs applied to the float32 result (``n`` signed, as
    glibc's quadrant: negated where ``n & 3`` is 1 or 2); below 2^-12 the
    cosine's polynomial itself rounds to glibc's 1."""
    from deap_tpu_torch import _xla_math as X
    c0, c1, c2, c3, c4 = X._COS_POLY
    s1_, s2_, s3_ = X._SIN_POLY
    x = y.double()
    n = (torch.trunc(x * X._HPI_INV).long() + 0x800000) >> 24
    xr = x + -(n.double() * X._HPI)
    x2 = xr * xr
    x3 = xr * x2
    vs = (xr + x3 * s1_) + (x3 * x2) * (s2_ + x2 * s3_)
    x4 = x2 * x2
    vc = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    v = torch.where(n % 2 == 1, vs, vc).float()
    return torch.where((n + 1) & 2 != 0, -v, v)


def test_branch_free_cosine_equals_glibcs_on_every_input_of_the_law():
    """P2's cosine takes no branch of ``xla_sincos``: on 2 pi u2 for every
    one of the 2^24 uniforms u2 its sequence gives the plain cosine's
    bits (the kernel itself is held to the plain version on the card)."""
    from deap_tpu_torch import _xla_math
    from deap_tpu_torch.probes.ga import _F32_2PI
    for lo in range(0, 1 << 24, 1 << 21):
        u2 = torch.arange(lo, lo + (1 << 21)).float() * 5.9604644775390625e-08
        y = u2 * _F32_2PI
        assert torch.equal(_cos_reduced(y).view(torch.int32),
                           _xla_math.cos(y).view(torch.int32))


def test_branch_free_cosine_equals_glibcs_on_a_sample_of_its_range():
    """``cos_reduced``'s range is ``|y| < 120``, both signs (+-0 and the
    inputs below 2^-12 and 0.75 included): on every 61st float32 bit
    pattern of it, its transcription gives ``_xla_math.cos``'s bits.  The
    card test sweeps every pattern through the kernel's own cosine."""
    from deap_tpu_torch import _xla_math
    top, step, chunk = 0x42F00000, 61, 1 << 22      # 0x42F00000 is 120.0
    for sign in (0, -(1 << 31)):
        for lo in range(0, top, chunk * step):
            bits = torch.arange(lo, min(lo + chunk * step, top), step)
            y = (bits + sign).to(torch.int32).view(torch.float32)
            assert torch.equal(_cos_reduced(y).view(torch.int32),
                               _xla_math.cos(y).view(torch.int32))


def _probe_rows_inputs(dev, pop):
    key = random.PRNGKey(9, device=dev)
    k_x, k_i = random.split(key)
    x = random.uniform(k_x, (pop, PGA.LANE), minval=-5.12, maxval=5.12)
    idx = random.randint(k_i, (pop,), 0, pop)
    return x, idx


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [512, 2048, 8192])
def test_probe_stream_and_chain_equal_plain_on_card(rows):
    dev = _cuda()
    x, _ = _probe_rows_inputs(dev, (1 << 16) + 96)     # a ragged last block
    kernels.reset_launches()
    copy, chain = PGA.stream(x, rows), PGA.chain24(x)
    want = PGA._chain24_plain(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_stream_copy"] == 1
    assert kernels.LAUNCHES["probe_chain24"] == 1
    assert _same(copy, x) and _same(chain, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [512, 2048, 8192])
@pytest.mark.parametrize("n_rows", [1, 33, 3 * 8192 + 5, (1 << 20) - 7])
def test_probe_stream_copy_exact_at_ragged_sizes_on_card(rows, n_rows):
    """P1's bulk copy equals ``x.clone()`` exactly when ``n_rows`` is not
    a multiple of ``rows`` (a ragged last tile, and a last chunk shorter
    than a stage), and from a view one row into its allocation."""
    dev = _cuda()
    full = random.uniform(random.PRNGKey(rows + n_rows, device=dev),
                          (n_rows + 1, PGA.LANE))
    for x in (full[:n_rows], full[1:]):
        kernels.reset_launches()
        copy = PGA.stream(x, rows)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["probe_stream_copy"] == 1
        assert _same(copy, x.clone())


@pytest.mark.gpu
def test_probe_stream_copy_refuses_a_misaligned_view_on_card():
    """The bulk copier needs 16-byte aligned addresses: a view that
    starts one float into its allocation is refused, not copied some
    other way, and nothing is launched."""
    dev = _cuda()
    flat = torch.zeros(64 * PGA.LANE + 1, device=dev)
    x = flat[1:].view(64, PGA.LANE)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        PGA.stream(x, 512)
    with pytest.raises(ValueError, match="rows"):
        PGA.stream(flat[:-1].view(64, PGA.LANE), 0)
    assert kernels.LAUNCHES["probe_stream_copy"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [1, 2047, 2048, 2049, (1 << 16) + 96])
@pytest.mark.parametrize("dim", [0, 1, 31, 32, 33, 37, 96, 100, 127, 128])
def test_probe_rast_reduce_equals_plain_on_card(dim, n_rows):
    """P1's reduce bitwise to its plain version, masked lanes skipped
    (dims up to 96 leave the fourth window empty) and warps on the
    branch-free and the general cosine (``probes.ga.rast_inputs``)."""
    dev = _cuda()
    x = PGA.rast_inputs(n_rows, dev)
    kernels.reset_launches()
    got = PGA.rast_reduce(x, dim)
    want = PGA._rast_reduce_plain(x, dim)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_rast_reduce"] == 1
    assert got.shape == (x.shape[0],) and _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("lo, hi", [(0, 0x42F00000),
                                    (0x80000000, 0xC2F00000)],
                         ids=["positive", "negative"])
def test_branch_free_cosine_equals_xla_sincos_on_its_whole_range_on_card(
        lo, hi):
    """Every float32 ``y`` with ``|y| < 120`` (0x42F00000 is 120.0):
    ``cos_reduced`` gives ``xla_sincos(y, true)``'s bits on the card.
    Above the range (``|y|`` from 120 to 2^22, where glibc reduces in
    128-bit integers) the sweep finds mismatches, so it can see one."""
    dev = _cuda()
    assert kernels._cos_reduced_mismatches(lo, hi, device=dev) == (0, None)
    above = hi + 0x07900000                    # 0x4A800000 is 2^22
    count, first = kernels._cos_reduced_mismatches(hi, above, device=dev)
    assert count > 0 and hi <= first < above


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [(1 << 16) + 96, 1, 2047, 2049])
@pytest.mark.parametrize("seed", [0, 12345, -7])
def test_probe_hash_normal_equals_plain_on_card(seed, n_rows):
    dev = _cuda()
    s = torch.tensor([seed], dtype=torch.int32, device=dev)
    kernels.reset_launches()
    got = PGA.hash_normal(s, n_rows)
    want = PGA._hash_normal_plain(s, n_rows)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_hash_normal"] == 1
    assert got.shape == (n_rows, PGA.LANE) and _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_probe_lookup_exact_at_ragged_sizes_and_views_on_card(n, offset):
    """P3 is exactly ``order[pos]`` with a table of another size than
    ``n``, positions 0 and m - 1 among the queries, sizes that are not
    a multiple of 4 and ``pos`` a view 0-3 words into its allocation
    (not 16-byte aligned)."""
    order, pos = PGA.lookup_inputs(n, offset, _cuda())
    kernels.reset_launches()
    got = PGA.lookup(order, pos)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_lookup"] == 1
    assert got.shape == (n,) and torch.equal(got, order[pos.long()])


@pytest.mark.gpu
def test_probe_lookup_and_row_gather_equal_plain_on_card():
    dev = _cuda()
    x, idx = _probe_rows_inputs(dev, (1 << 16) + 96)
    order = torch.argsort(x[:, 0]).to(torch.int32)
    kernels.reset_launches()
    looked = PGA.lookup(order, idx)
    rows = PGA.row_gather(x, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_lookup"] == 1
    assert kernels.LAUNCHES["probe_row_gather"] == 1
    assert torch.equal(looked, order[idx.long()])
    assert _same(rows, x[idx.long()])


#: the names of ``probes.gp.probe_edges``
EDGE_NAMES = ["pop 4097", "1000 points", "1 point",
              "cap 256, lengths below 63", "cap 256, lengths up to 256",
              "codes outside 9 branches", "codes outside 4 branches"]


@pytest.fixture(scope="module")
def probe_gp_inputs():
    """200 full trees at 1000 points (key ``None``) and
    ``probes.gp.probe_edges``, built once on the card."""
    dev = _cuda()
    return {None: (*PGP.full_binary_trees(PGP.bench_pset(),
                                          np.random.default_rng(1), 200, 64,
                                          dev), 1000, 9),
            **PGP.probe_edges(dev)}


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [None, *EDGE_NAMES])
@pytest.mark.parametrize("unroll", [0, 63], ids=["unroll1", "unroll63"])
@pytest.mark.parametrize("tb", [8, 32])
@pytest.mark.parametrize("mode", ["noswitch", "dispatch", "stackrw"])
def test_probe_gp_equals_plain_on_card(probe_gp_inputs, mode, tb, unroll,
                                       edge):
    codes, consts, lengths, n_points, nb = probe_gp_inputs[edge]
    x = torch.zeros((1, 1), device=codes.device)
    kernels.reset_launches()
    got = PGP.make_probe_kernel(mode, nb, tb, unroll, n_points=n_points)(
        codes, consts, lengths, x)
    want = PGP._probe_gp_plain(codes, consts, lengths, n_points, mode, tb,
                               bool(unroll), nb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_gp"] == 1
    assert got.shape == (codes.shape[0], n_points) and _same(got, want)


def test_probe_gp_edges_are_the_card_tests_cases():
    edges = PGP.probe_edges("cpu")
    assert list(edges) == EDGE_NAMES
    for codes, consts, lengths, n_points, nb in edges.values():
        assert codes.shape == consts.shape and lengths.shape == codes.shape[:1]
        assert 1 <= nb <= 9 and n_points >= 1
