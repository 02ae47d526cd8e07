"""deap_tpu_torch.gp against the jitted JAX package, module by module.

The same keys (made from a seed by JAX and carried as numpy words) go
through the JAX function, ``jax.vmap``ped over per-row keys as the JAX
package's loops call it, and through the port's row-batched counterpart.
Everything is bitwise: row-batched keys and draws (tensor bounds
included), the primitive-set tables, the generators (typed and untyped),
subtree bounds, depths and heights, both crossovers, uniform mutation,
and the plain interpreter against both JAX interpreters (the vmapped XLA
one and the Pallas kernel in interpret mode).  ``sin``/``cos`` are
glibc's ``sinf``/``cosf``, which XLA's CPU backend calls, reproduced in
float64: the stated ulp bound is 0 for every op.  XLA's CPU backend
flushes subnormal operands and results to zero and the port does not, so
the inputs avoid subnormals (the GP data do not produce them).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deap_tpu import gp as jgp
from deap_tpu.gp.interp_pallas import make_population_evaluator_pallas
from deap_tpu_torch import _xla_math as xm
from deap_tpu_torch import base as tbase, gp as tgp, interop, kernels
from deap_tpu_torch import random as tr
from deap_tpu_torch.algorithms import _apply_op

# the tensors here are small: extra intra-op threads would only contend
# with the suite's other test workers
torch.set_num_threads(1)

CAP, POP, NPTS = 32, 48, 96
ULP_BOUND = 0


def _same(a, b):
    """Bitwise equality of float or int arrays; NaNs of any payload
    count as equal."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        eq = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a)
                                                         & np.isnan(b))
        return bool(eq.all())
    return np.array_equal(a, b.astype(a.dtype))


def _tree_same(jt, tt):
    return all(_same(a, b.numpy()) for a, b in zip(jt, tt))


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.from_numpy(np.asarray(jk).astype(np.int64))


# ---- the bench's primitive set (bench_gp.py) and one with every opcode ----

def _jax_bench_pset():
    ps = jgp.PrimitiveSet("MAIN", 1)
    for f, a, n in ((jnp.add, 2, "add"), (jnp.subtract, 2, "sub"),
                    (jnp.multiply, 2, "mul"), (jgp.protected_div, 2, "div"),
                    (jnp.negative, 1, "neg"), (jnp.cos, 1, "cos"),
                    (jnp.sin, 1, "sin")):
        ps.add_primitive(f, a, name=n)
    ps.add_ephemeral_constant(
        "rand101",
        lambda key: jax.random.randint(key, (), -1, 2).astype(jnp.float32))
    return ps


def _torch_bench_pset():
    ps = tgp.PrimitiveSet("MAIN", 1)
    for f, a, n in ((torch.add, 2, "add"), (torch.subtract, 2, "sub"),
                    (torch.multiply, 2, "mul"), (tgp.protected_div, 2, "div"),
                    (torch.negative, 1, "neg"), (tgp.cos, 1, "cos"),
                    (tgp.sin, 1, "sin")):
        ps.add_primitive(f, a, name=n)
    ps.add_ephemeral_constant(
        "rand101", lambda keys: tr.randint(keys, (), -1, 2).float())
    return ps


def _all_ops_psets():
    """Every opcode of the kernel's table: all of ``safe_ops`` and
    ``bool_ops``, two arguments, a terminal and an ephemeral."""
    out = []
    for g, ops, eph in (
            (jgp, {**jgp.safe_ops, **jgp.bool_ops},
             lambda key: jax.random.uniform(key, (), jnp.float32, -2.0, 2.0)),
            (tgp, {**tgp.safe_ops, **tgp.bool_ops},
             lambda keys: tr.uniform(keys, (), minval=-2.0, maxval=2.0))):
        ps = g.PrimitiveSet("ALL", 2)
        for name, (f, a) in ops.items():
            ps.add_primitive(f, a, name=name)
        ps.add_terminal(1.0, name="one")
        ps.add_ephemeral_constant("u", eph)
        out.append(ps)
    return out


def _typed_psets():
    """A typed set: float and bool values, an if-then-else over them."""
    out = []
    for g, where, lt in ((jgp, jnp.where, jnp.less),
                         (tgp, torch.where, torch.lt)):
        ps = g.PrimitiveSetTyped("TYPED", [float, float], float)
        ps.add_primitive(lambda a, b: a + b, [float, float], float,
                         name="add")
        ps.add_primitive(lambda a: -a, [float], float, name="neg")
        ps.add_primitive(lt, [float, float], bool, name="lt")
        ps.add_primitive(where, [bool, float, float], float, name="ite")
        ps.add_terminal(1.0, bool, name="true")
        ps.add_terminal(0.0, bool, name="false")
        ps.add_terminal(2.0, float, name="two")
        out.append(ps)
    return out


# ---- keys and draws ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_row_batched_keys_and_draws_bitwise(seed):
    jk, tk = _keys(seed, 40)
    vm = lambda f: jax.jit(jax.vmap(f))                    # noqa: E731
    assert _same(vm(lambda k: jax.random.split(k, 3))(jk),
                 tr.split(tk, 3).numpy())
    assert _same(vm(lambda k: jax.random.split(k, (2, 3)))(jk),
                 tr.split(tk, (2, 3)).numpy())
    assert _same(vm(lambda k: jax.random.fold_in(k, 11))(jk),
                 tr.fold_in(tk, 11).numpy())
    assert _same(vm(lambda k: jax.random.bits(k, (5,)))(jk),
                 tr.bits(tk, (5,)).numpy().astype(np.uint32))
    assert _same(vm(lambda k: jax.random.uniform(k, (7,)))(jk),
                 tr.uniform(tk, (7,)).numpy())
    assert _same(vm(lambda k: jax.random.uniform(k, (), jnp.float32, -2.0,
                                                 2.0))(jk),
                 tr.uniform(tk, (), minval=-2.0, maxval=2.0).numpy())
    assert _same(vm(lambda k: jax.random.bernoulli(k, 0.3, (6,)))(jk),
                 tr.bernoulli(tk, 0.3, (6,)).numpy())
    assert _same(vm(lambda k: jax.random.randint(k, (3,), -1, 2))(jk),
                 tr.randint(tk, (3,), -1, 2).numpy())


def test_randint_tensor_bounds_bitwise():
    """Traced per-row bounds: spans of 1 and more, ``maxval <= minval``
    (returns ``minval``), bounds beyond int32 and spans that are not a
    power of two."""
    jk, tk = _keys(3, 64)
    rng = np.random.default_rng(0)
    lo = rng.integers(-5, 5, 64).astype(np.int32)
    hi = (lo + rng.integers(-3, 40, 64)).astype(np.int32)
    hi[:4] = [2**31 - 1, lo[1], lo[2] - 1, 1]
    jr = jax.jit(jax.vmap(lambda k, a, b: jax.random.randint(k, (), a, b)))
    assert _same(jr(jk, lo, hi), tr.randint(tk, (), torch.from_numpy(lo),
                                            torch.from_numpy(hi)).numpy())
    jr5 = jax.jit(jax.vmap(lambda k, b: jax.random.randint(k, (5,), 0, b)))
    assert _same(jr5(jk, hi), tr.randint(tk, (5,), 0,
                                         torch.from_numpy(hi)).numpy())
    # a length-dependent bound, as mut_uniform draws its point
    lengths = np.maximum(rng.integers(0, CAP, 64), 1).astype(np.int32)
    jr1 = jax.jit(jax.vmap(lambda k, n: jax.random.randint(
        k, (), 0, jnp.maximum(n, 1))))
    assert _same(jr1(jk, lengths), tr.randint(
        tk, (), 0, torch.from_numpy(lengths).clamp(min=1)).numpy())


# ---- XLA's transcendentals --------------------------------------------------

def _float_battery():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-4, 4, 20000), rng.uniform(-130, 130, 5000),
        10 ** rng.uniform(-6, 9, 5000) * rng.choice([-1, 1], 5000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 0.75, 120.0, -120.0, 3e38,
         2.0**-12, 1e-30]]).astype(np.float32)
    return x


@pytest.mark.parametrize("name", ["sin", "cos"])
def test_sin_cos_equal_xla_bitwise(name):
    x = _float_battery()
    j = np.asarray(jax.jit(getattr(jnp, name))(x))
    t = getattr(xm, name)(torch.from_numpy(x)).numpy()
    assert _same(j, t)


@pytest.mark.parametrize("name", ["div", "log", "sqrt", "lf"])
def test_protected_ops_equal_xla_bitwise(name):
    x = _float_battery()
    y = np.roll(x, 17)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if name == "div":
        j = jax.jit(jgp.protected_div)(x, y)
        t = tgp.protected_div(tx, ty)
        # XLA flushes subnormal quotients to zero: keep them out
        normal = ~((np.abs(x / np.where(y == 0, 1, y)) < 1.2e-38)
                   & (x != 0))
        assert _same(np.asarray(j)[normal], t.numpy()[normal])
        return
    jf = {"log": jgp.protected_log, "sqrt": jgp.protected_sqrt,
          "lf": jgp.logistic}[name]
    tf = {"log": tgp.protected_log, "sqrt": tgp.protected_sqrt,
          "lf": tgp.logistic}[name]
    keep = x > -80 if name == "lf" else np.ones_like(x, bool)   # no subnormal
    assert _same(np.asarray(jax.jit(jf)(x))[keep], tf(tx).numpy()[keep])


# ---- primitive sets -----------------------------------------------------------

@pytest.mark.parametrize("which", ["bench", "all", "typed"])
def test_frozen_pset_tables_equal(which):
    jp, tp = {"bench": (_jax_bench_pset(), _torch_bench_pset()),
              "all": tuple(_all_ops_psets()),
              "typed": tuple(_typed_psets())}[which]
    jf, tf = jp.freeze(), tp.freeze()
    assert jf.names == tf.names and jf.n_nodes == tf.n_nodes
    for attr in ("arity", "ret_type", "in_types", "is_primitive",
                 "is_ephemeral", "is_argument", "arg_index", "const_value",
                 "args_have_terminals"):
        assert _same(getattr(jf, attr), getattr(tf, attr)), attr
    for attr in ("prim_by_type", "term_by_type"):
        for a, b in zip(getattr(jf, attr), getattr(tf, attr)):
            assert _same(a, b), attr
    assert jf.terminal_ratio == tf.terminal_ratio
    assert jf.max_arity == tf.max_arity
    if which == "typed":
        assert tf.kernel_form_missing == ["add", "neg", "lt", "ite"]
    else:
        assert tf.kernel_form_missing == []
        assert (tf.op_kind >= 0).all()


# ---- generation ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "grow", "half_and_half"])
@pytest.mark.parametrize("which", ["bench", "typed"])
def test_generators_bitwise(kind, which):
    jp, tp = _bench_psets() if which == "bench" else _typed_psets()
    jk, tk = _keys(11, POP)
    jg, tg = jgp.make_generator(jp, CAP, kind), tgp.make_generator(tp, CAP,
                                                                  kind)
    jt = (_jax_gen(kind, 1, 4)(jk) if which == "bench"
          else jax.jit(jax.vmap(lambda k: jg(k, 1, 4)))(jk))
    tt = tg(tk, 1, 4)
    assert _tree_same(jt, tt)
    assert int(tt[2].max()) > 4
    if which == "typed":
        # a traced return type per row, as typed mut_uniform passes it
        rt = np.arange(POP, dtype=np.int32) % 2
        jt = jax.jit(jax.vmap(lambda k, r: jg(k, 0, 2, r)))(jk, rt)
        assert _tree_same(jt, tg(tk, 0, 2, torch.from_numpy(rt)))


def test_generator_capacity_guard_bitwise():
    """Deep trees at a small capacity: the terminal guard cuts them."""
    jp, tp = _bench_psets()
    jk, tk = _keys(5, 24)
    jg, tg = (jgp.make_generator(jp, 16, "full"),
              tgp.make_generator(tp, 16, "full"))
    jt = jax.jit(jax.vmap(lambda k: jg(k, 5, 6)))(jk)
    tt = tg(tk, 5, 6)
    assert _tree_same(jt, tt)
    assert int(tt[2].max()) <= 16


@functools.lru_cache(maxsize=None)
def _bench_psets():
    return _jax_bench_pset(), _torch_bench_pset()


@functools.lru_cache(maxsize=None)
def _jax_gen(kind, lo, hi, cap=CAP):
    """One jitted, vmapped JAX generator per shape: compiled once for the
    whole module."""
    jg = jgp.make_generator(_bench_psets()[0], cap, kind)
    return jax.jit(jax.vmap(lambda k: jg(k, lo, hi)))


def _bench_trees(seed=1, n=POP, lo=1, hi=4):
    jp, tp = _bench_psets()
    jk, tk = _keys(seed, n)
    jt = _jax_gen("half_and_half", lo, hi)(jk)
    return jp, tp, jt, tuple(torch.from_numpy(np.array(x)) for x in jt)


# ---- variation -----------------------------------------------------------------

def test_subtree_bounds_depths_heights_bitwise():
    jp, tp, jt, tt = _bench_trees()
    arity = jnp.asarray(jp.freeze().arity)
    tar = tp.freeze().tables("cpu")["arity"]
    rng = np.random.default_rng(2)
    i = (rng.integers(0, 1 << 20, POP) % np.maximum(np.asarray(jt[2]), 1)
         ).astype(np.int32)
    js, je = jax.jit(jax.vmap(lambda c, l, k: jgp.subtree_bounds(
        c, l, k, arity)))(jt[0], jt[2], i)
    ts, te = tgp.subtree_bounds(tt[0], tt[2], torch.from_numpy(i), tar)
    assert _same(js, ts.numpy()) and _same(je, te.numpy())
    jd = jax.jit(jax.vmap(lambda c, l: jgp.node_depths(c, l, arity)))(
        jt[0], jt[2])
    assert _same(jd, tgp.node_depths(tt[0], tt[2], tar).numpy())
    jh = jax.jit(jax.vmap(lambda c, l: jgp.tree_height(c, l, arity)))(
        jt[0], jt[2])
    assert _same(jh, tgp.tree_height(tt[0], tt[2], tar).numpy())


@pytest.mark.parametrize("op", ["cx_one_point", "cx_one_point_leaf_biased"])
def test_crossover_bitwise(op):
    jp, tp, jt, tt = _bench_trees(seed=4, lo=1, hi=5)
    h = POP // 2
    jk, tk = _keys(9, h)
    jop, top = getattr(jgp, op), getattr(tgp, op)
    jc = jax.jit(jax.vmap(lambda k, a, b: jop(k, a, b, jp)))(
        jk, tuple(x[:h] for x in jt), tuple(x[h:] for x in jt))
    tc = top(tk, tuple(x[:h] for x in tt), tuple(x[h:] for x in tt), tp)
    assert _tree_same(jc[0], tc[0]) and _tree_same(jc[1], tc[1])
    changed = (tc[0][2] != tt[2][:h]) | (tc[0][0] != tt[0][:h]).any(1)
    assert int(changed.sum()) > h // 3


def test_crossover_typed_and_overflow_bitwise():
    """Typed trees, and a capacity so small that some children would
    overflow it (their parents are kept)."""
    jp, tp = _typed_psets()
    jk, tk = _keys(21, POP)
    jg = jgp.make_generator(jp, 12, "grow")
    jt = jax.jit(jax.vmap(lambda k: jg(k, 1, 4)))(jk)
    tt = tuple(torch.from_numpy(np.array(x)) for x in jt)
    h = POP // 2
    jk2, tk2 = _keys(22, h)
    jc = jax.jit(jax.vmap(lambda k, a, b: jgp.cx_one_point(k, a, b, jp)))(
        jk2, tuple(x[:h] for x in jt), tuple(x[h:] for x in jt))
    tc = tgp.cx_one_point(tk2, tuple(x[:h] for x in tt),
                          tuple(x[h:] for x in tt), tp)
    assert _tree_same(jc[0], tc[0]) and _tree_same(jc[1], tc[1])


@pytest.mark.parametrize("typed_expr", [False, True])
def test_mut_uniform_bitwise(typed_expr):
    jp, tp, jt, tt = _bench_trees(seed=6, lo=1, hi=5)
    jk, tk = _keys(13, POP)
    jgm = jgp.make_generator(jp, CAP, "full")
    tgm = tgp.make_generator(tp, CAP, "full")
    if typed_expr:
        jexpr = lambda kk, rt: jgm(kk, 0, 2, rt)          # noqa: E731
        texpr = lambda kk, rt: tgm(kk, 0, 2, rt)          # noqa: E731
    else:
        jexpr = lambda kk: jgm(kk, 0, 2)                  # noqa: E731
        texpr = lambda kk: tgm(kk, 0, 2)                  # noqa: E731
    jm = jax.jit(jax.vmap(lambda k, t: jgp.mut_uniform(k, t, jexpr, jp)))(
        jk, jt)
    tm = tgp.mut_uniform(tk, tt, texpr, tp)
    assert _tree_same(jm, tm)


def test_rowwise_operators_dispatch_once_with_split_keys():
    """``Toolbox.register`` keeps the ``rowwise_op`` mark: ``_apply_op``
    calls the operator once with ``split(key, n)``, which equals
    ``jax.vmap(tool)(split(key, n), ...)``."""
    jp, tp, jt, tt = _bench_trees(seed=8)
    tb = tbase.Toolbox()
    calls = []

    def counted(keys, a, b, pset):
        calls.append(keys.shape)
        return tgp.cx_one_point(keys, a, b, pset)
    counted.rowwise = True
    tb.register("mate", counted, pset=tp)
    tb.register("mate2", tgp.cx_one_point, pset=tp)
    assert getattr(tb.mate2, "rowwise", False)
    h = POP // 2
    key = jax.random.PRNGKey(31)
    ja, jb = tuple(x[:h] for x in jt), tuple(x[h:] for x in jt)
    ta, tb_ = tuple(x[:h] for x in tt), tuple(x[h:] for x in tt)
    jc = jax.jit(lambda k: jax.vmap(lambda kk, a, b: jgp.cx_one_point(
        kk, a, b, jp))(jax.random.split(k, h), ja, jb))(key)
    tc = _apply_op(tb.mate, interop.key_to_torch(key, device="cpu"), h, ta,
                   tb_)
    assert calls == [(h, 2)]
    assert _tree_same(jc[0], tc[0]) and _tree_same(jc[1], tc[1])


# ---- the interpreter -------------------------------------------------------------

def _eval_all(jp, tp, trees, X):
    jev = jax.jit(jgp.make_population_evaluator(jp, CAP, backend="xla"))
    jpl = make_population_evaluator_pallas(jp, CAP, interpret=True)
    tev = tgp.make_population_evaluator(tp, CAP)
    out = tev(*(torch.from_numpy(np.array(x)) for x in trees),
              torch.from_numpy(X))
    assert tev.last_backend == "plain" and tev.resolve(
        torch.from_numpy(X)) == "plain"
    return np.asarray(jev(*trees, X)), np.asarray(jpl(*trees, X)), out.numpy()


def test_interpreter_bench_pset_bitwise():
    jp, tp, jt, _ = _bench_trees(seed=3, lo=2, hi=6)
    X = np.linspace(-1, 1, NPTS, dtype=np.float32)[None, :]
    kernels.reset_launches()
    xla, pallas, port = _eval_all(jp, tp, jt, X)
    assert _same(xla, port) and _same(pallas, port)
    assert kernels.LAUNCHES["gp_interp"] == 0     # CPU: the plain version
    assert np.isfinite(port).mean() > 0.9


def test_interpreter_every_opcode_bitwise():
    jp, tp = _all_ops_psets()
    jk, _ = _keys(17, POP)
    jg = jgp.make_generator(jp, CAP, "half_and_half")
    jt = jax.jit(jax.vmap(lambda k: jg(k, 2, 5)))(jk)
    X = np.stack([np.linspace(-1, 1, NPTS), np.linspace(3, -2, NPTS)]
                 ).astype(np.float32)
    xla, pallas, port = _eval_all(jp, tp, jt, X)
    assert _same(xla, port) and _same(pallas, port)
    used = set(np.asarray(jt[0])[np.arange(CAP)[None, :]
                                 < np.asarray(jt[2])[:, None]].tolist())
    assert used >= set(range(tp.freeze().n_nodes))    # every node ran


def test_interpreter_length_zero_rows_give_zeros():
    jp, tp, jt, tt = _bench_trees(seed=2)
    lengths = np.asarray(jt[2]).copy()
    lengths[::3] = 0
    jt = (jt[0], jt[1], jnp.asarray(lengths))
    X = np.linspace(-1, 1, NPTS, dtype=np.float32)[None, :]
    xla, pallas, port = _eval_all(jp, tp, jt, X)
    assert _same(xla, port) and _same(pallas, port)
    assert (port[::3] == 0).all()


@pytest.mark.parametrize("which", ["bench", "all"])
@pytest.mark.parametrize("n_points", [1, 1000])
def test_interpreter_deepest_stack_bitwise(which, n_points):
    """The plain interpreter against the JAX package's
    ``run_stack_machine`` (jitted, vmapped) on comb trees of exactly
    ``cap`` = 64 tokens: a left comb (every leaf pushed before the first
    operator runs, the deepest stack 64 tokens make), ``if`` combs at
    depth (the every-opcode set) and right combs, at 1 and 1000 points."""
    from deap_tpu_torch.probes.gp import comb_trees
    jp, tp = _bench_psets() if which == "bench" else _all_ops_psets()
    cap = 64
    tt = comb_trees(tp, np.random.default_rng(5), 6, cap, device="cpu")
    assert (tt[2] == cap).all()
    X = np.stack([np.linspace(-1, 1, n_points), np.linspace(3, -2, n_points)]
                 )[:len(tp.arguments)].astype(np.float32)
    jev = jax.jit(jax.vmap(jgp.make_evaluator(jp, cap),
                           in_axes=(0, 0, 0, None)))
    jout = jev(*(jnp.asarray(t.numpy()) for t in tt), X)
    port = tgp.run_stack_machine(*tt, torch.from_numpy(X), tp.freeze(), cap)
    assert port.shape == (6, n_points)
    assert _same(jout, port.numpy())


def test_make_evaluator_and_compile_tree():
    jp, tp = _bench_psets()
    tree = tgp.from_string("add(mul(ARG0, ARG0), sin(ARG0))", tp, cap=CAP)
    f = tgp.compile_tree(tuple(torch.from_numpy(np.array(x)) for x in tree),
                         tp)
    jf = jgp.compile_tree(jgp.from_string("add(mul(ARG0, ARG0), sin(ARG0))",
                                          jp, cap=CAP), jp)
    assert f(0.5) == float(jf(0.5))
    xs = np.linspace(-1, 1, 9, dtype=np.float32)
    assert _same(np.asarray(jf(xs)), f(torch.from_numpy(xs)).numpy())


def test_kernel_form_unavailable_on_cuda_request():
    ps = tgp.PrimitiveSet("SIN", 1)
    ps.add_primitive(torch.sin, 1, name="tsin")       # no kernel form
    ps.add_primitive(torch.add, 2, name="add")
    assert ps.freeze().kernel_form_missing == ["tsin"]
    with pytest.raises(tgp.KernelFormUnavailable, match="tsin"):
        tgp.make_population_evaluator(ps, CAP, backend="cuda")
    ev = tgp.make_population_evaluator(ps, CAP, backend="plain")
    X = torch.linspace(-1, 1, 8)[None, :]
    tree = tgp.from_string("tsin(add(ARG0, ARG0))", ps, cap=CAP)
    out = ev(*(torch.from_numpy(np.array(x))[None] for x in tree[:2]),
             torch.tensor([tree[2]]), X)
    assert torch.equal(out[0], torch.sin(X[0] + X[0]))
    with pytest.raises(ValueError, match="backend"):
        tgp.make_population_evaluator(ps, CAP, backend="xla")
    with pytest.raises(ValueError, match="CUDA"):
        tgp.make_population_evaluator(_bench_psets()[1], CAP,
                                      backend="cuda").resolve(X)


def test_kernel_launcher_refuses_cpu_tensors():
    f = _bench_psets()[1].freeze()
    t = f.tables("cpu")
    codes = torch.zeros((4, CAP), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch_gp_interp(codes, codes.float(), codes[:, 0],
                                 torch.zeros((1, 8)), t["op_kind"],
                                 t["arg_index"])


# ---- strings and interop ----------------------------------------------------------

def test_to_string_from_string_round_trip():
    jp, tp, jt, tt = _bench_trees(seed=12, lo=1, hi=5)
    for r in range(0, POP, 5):
        js = jgp.to_string(tuple(np.asarray(x[r]) for x in jt), jp)
        ts = tgp.to_string(tuple(x[r] for x in tt), tp)
        assert js == ts
        back = tgp.from_string(ts, tp, cap=CAP)
        jback = jgp.from_string(js, jp, cap=CAP)
        assert all(_same(a, b) for a, b in zip(jback, back))
        assert tgp.to_string(back, tp) == ts
    with pytest.raises(TypeError, match="nope"):
        tgp.from_string("add(nope, ARG0)", tp)


def test_interop_carries_tree_genomes():
    jp, tp, jt, _ = _bench_trees(seed=14)
    values = np.arange(POP, dtype=np.float32)[:, None]
    pop = interop.population_to_torch(tuple(np.asarray(x) for x in jt),
                                      values, np.ones(POP, bool), (-1.0,),
                                      device="cpu")
    assert [x.dtype for x in pop.genome] == [torch.int32, torch.float32,
                                             torch.int32]
    g, v, valid, w = interop.population_to_numpy(pop)
    assert all(_same(a, b) for a, b in zip(jt, g))
    assert _same(values, v) and valid.all() and w == (-1.0,)
