"""Stage-level probes of the flagship GA generation on the card — the
port's counterpart of ``tools/pallas_probe_ga.py``, with the same probe
names and arguments::

    python -m deap_tpu_torch.probes.ga [probe ...] [--json PATH]
        [--recommend] [--pop N] [--dim D] [--device cuda|cpu]

Library-call probes (one PyTorch call a stage, no kernel of the port):
  sort        ``torch.argsort`` of (pop,) float32 keys; ``torch.sort`` int32
  gidx        ``order[pos]``: pop scalar reads from a pop-word table
              (indexing, ``torch.take``, and sorted positions with the sort)
  grow        ``genome[idx]``: pop row reads (indexing at d100; the
              ``index_select`` forms keep the JAX records' ``pib`` names:
              d100, d128, d100 bfloat16, sorted d128)
  varveval    the fused crossover + mutation + rastrigin chain on the
              port's ``random``, under threefry2x32 and under rbg keys
  hoststream  host <-> card copies of slice-sized pieces from pinned host
              buffers (float32 and int8) against a card ``index_select``
              moving the same traffic

Probe kernels (P1–P4, ``deap_tpu_torch/kernels/probes.cu``):
  stream      copy of (pop, 128) float32, rows 512 / 2048 / 8192 a block
  chain       the copy with 24 fused multiply-adds an element
  rng         counter-hash normals (the TPU probe drew the TPU's hardware
              bits, which have no counterpart on the card)
  rast        rastrigin's masked term, row-summed
  lookup      ``order[pos]`` from an L2-resident 4 MB table
  dmagather   ``genome[idx]`` rows, a warp 16 rows in flight

A kernel's wrapper launches it for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor; a record's name and ``route`` say which
(``cuda_…`` / ``plain_…``; ``torch_…`` for a library call).  Every record
carries the JAX record's fields (the marginal ``ms``, the linearity
witness, the walls, ``k``, the derived rates) and ``device`` (the card's
name and power limit, or ``"cpu"``); the kernels' records add the least
time of their work on the card (``bound_ms``, ``bound_by``).

Inputs are the JAX tool's, drawn with the port's threefry ``random``
under the JAX tool's keys (bitwise the same), the permutation tables of
``gidx`` (``split(PRNGKey(0))[1]``) and ``lookup`` (``PRNGKey(0)``)
included.

``--recommend`` folds the gather probes into the gather the port's
``fused_generation`` would take on this card: ``"dma"`` (K2's in-kernel
row gather) when the P4 kernel moves at least the GB/s of
``index_select`` at d128, else ``"host"``.  It is printed, and carried in
``--json``; the port's default does not read it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from .. import _xla_math, kernels, random
from .._device import resolve_device
from ..kernels.peaks import bound_ms
from ..ops.generation import M32, _uniform_at
from . import PAIRS, ProbeRun

__all__ = ["POP", "DIM", "LANE", "K_ITERS", "PROBES", "stream", "chain24",
           "rast_reduce", "rast_inputs", "hash_normal", "lookup",
           "lookup_inputs", "gidx_table", "lookup_table", "row_gather",
           "kernel_bound", "recommend_defaults", "main"]

POP = 1 << 20          # 1,048,576 -- the flagship population
DIM = 100
LANE = 128
K_ITERS = 48
VARVEVAL_K = 1         # a step draws 1e8 normals: fewer steps, same rule
_PLAIN_CHUNK = 1 << 15     # rows a plain version takes at once
_F32_2PI = float(np.float32(2.0 * np.pi))
_F32_1E7 = float(np.float32(1e-7))
_F32_CHAIN = float(np.float32(1.0000001))


def _by_rows(fn, n: int):
    """``fn(lo, hi)`` over row chunks, concatenated (bounded temporaries
    for the float64 steps of the plain versions)."""
    return torch.cat([fn(lo, min(lo + _PLAIN_CHUNK, n))
                      for lo in range(0, n, _PLAIN_CHUNK)])


# ---------------------------------------------------------------------------
# P1: copy, chain, rastrigin reduce
# ---------------------------------------------------------------------------


def stream(x: torch.Tensor, rows: int = 2048) -> torch.Tensor:
    """A copy of ``(n, 128)`` float32 ``x``."""
    if x.is_cuda:
        return kernels.launch_probe_stream_copy(x, rows=rows)
    return x.clone()


def _chain24_plain(x: torch.Tensor) -> torch.Tensor:
    def part(lo, hi):
        v = x[lo:hi]
        for _ in range(24):
            v = _xla_math.fma(v, _F32_CHAIN, _F32_1E7)
        return v
    return _by_rows(part, x.shape[0])


def chain24(x: torch.Tensor) -> torch.Tensor:
    """24 times ``v * 1.0000001 + 1e-7`` with one rounding each (XLA's
    CPU backend fuses the multiply into the add)."""
    if x.is_cuda:
        return kernels.launch_probe_chain24(x)
    return _chain24_plain(x)


def _rast_reduce_plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    lanes = torch.arange(LANE, device=x.device)

    def part(lo, hi):
        v = x[lo:hi]
        c = _xla_math.cos(v * _F32_2PI)
        t = _xla_math.fma(v, v, -(c * 10.0)) + 10.0
        t = torch.where(lanes < dim, t, 0.0)
        total = torch.zeros(hi - lo, dtype=torch.float32, device=x.device)
        for j in range(LANE // 32):             # XLA: 1 x 32 windows ...
            s = torch.zeros_like(total)
            for i in range(32 * j, 32 * j + 32):
                s = s + t[:, i]
            total = total + s                   # ... then their sum
        return total
    return _by_rows(part, x.shape[0])


def rast_reduce(x: torch.Tensor, dim: int = DIM) -> torch.Tensor:
    """``(n, 128)`` → ``(n,)``: ``sum(where(lane < dim, v² − 10 cos(2πv)
    + 10, 0))`` in XLA's form (``fma(v, v, −10 cos)``, glibc's ``cosf``)
    and order (four windows of 32 lanes, each from 0, then their sum)."""
    if x.is_cuda:
        return kernels.launch_probe_rast_reduce(x, dim=dim)
    return _rast_reduce_plain(x, dim)


def rast_inputs(n_rows: int, device=None) -> torch.Tensor:
    """``(n_rows, 128)`` float32 for testing the reduce: rows of
    rastrigin's domain [-5.12, 5.12), where every ``2 pi v`` lies inside
    the kernel's branch-free cosine's range (``|2 pi v| < 120``), mixed
    with rows holding one lane outside it at 40 (so that a warp holds both
    paths), rows wholly outside it (``|v|`` in [20, 1e4)) and rows with
    NaN, +inf or -inf in one lane; drawn from a key of ``n_rows``."""
    dev = resolve_device(device)
    k_x, k_far, k_lane = random.split(random.PRNGKey(n_rows, device=dev),
                                      3)
    x = random.uniform(k_x, (n_rows, LANE), minval=-5.12, maxval=5.12)
    far = random.uniform(k_far, (n_rows, LANE), minval=20.0,
                         maxval=1e4) * torch.sign(x)
    rows = torch.arange(n_rows, device=dev)
    x = torch.where((rows % 11 == 5)[:, None], far, x)
    odd = {3: 40.0, 0: float("nan"), 6: float("inf"), 9: -float("inf")}
    lane = random.randint(k_lane, (n_rows,), 0, LANE).long()
    for r, value in odd.items():
        hit = rows[rows % (7 if r == 3 else 13) == r]
        x[hit, lane[hit]] = value
    return x


# ---------------------------------------------------------------------------
# P2: counter-hash normals
# ---------------------------------------------------------------------------


def _hash_normal_plain(seed: torch.Tensor, n_rows: int) -> torch.Tensor:
    useed = seed.reshape(()).to(torch.int64) & M32
    lanes = torch.arange(LANE, dtype=torch.int64, device=seed.device)[None]

    def part(lo, hi):
        rows = torch.arange(lo, hi, dtype=torch.int64,
                            device=seed.device)[:, None]
        u1 = _uniform_at(useed, 6, rows, lanes) + _F32_1E7
        u2 = _uniform_at(useed, 7, rows, lanes)
        radius = _xla_math.sqrt(-2.0 * _xla_math.log(u1))
        return radius * _xla_math.cos(_F32_2PI * u2)
    return _by_rows(part, n_rows)


def hash_normal(seed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``(n_rows, 128)`` normals: uniforms ``u``, ``u2`` of the megakernel's
    counter hash of ``seed`` (``(1,)`` int32) at draws 6 and 7, then the
    TPU probe's law ``sqrt(-2 log(u + 1e-7)) cos(2π u2)`` with XLA's
    ``log`` and glibc's ``cosf``."""
    if seed.is_cuda:
        return kernels.launch_probe_hash_normal(seed, n_rows)
    return _hash_normal_plain(seed, n_rows)


# ---------------------------------------------------------------------------
# P3 and P4: lookup and row gather
# ---------------------------------------------------------------------------


def lookup(order: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``order[pos]`` for int32 ``order`` and ``pos``, every position in
    ``[0, len(order))``: the kernel does not check it."""
    if pos.is_cuda:
        return kernels.launch_probe_lookup(order, pos)
    return order[pos.long()]


def lookup_inputs(n: int, offset: int = 0, device=None) -> tuple:
    """``(order, pos)`` for testing the lookup: a permutation table of
    ``n // 3 + 17`` entries (another size than ``n``) and ``n`` positions
    into it, the first 0 and the last the table's last, ``pos`` a view
    ``offset`` words into its allocation (not 16-byte aligned unless
    ``offset % 4 == 0``); drawn from a seed of ``n`` and ``offset``."""
    dev = resolve_device(device)
    m = n // 3 + 17
    gen = torch.Generator(device=dev).manual_seed(n + offset)
    order = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
    pos = torch.randint(0, m, (n + offset,), generator=gen, device=dev,
                        dtype=torch.int32)[offset:]
    pos[0], pos[-1] = 0, m - 1
    return order, pos


def row_gather(genome: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``genome[idx]`` for ``(m, 128)`` float32 rows, every index in
    ``[0, m)``: the kernel does not check it."""
    if idx.is_cuda:
        return kernels.launch_probe_row_gather(genome, idx)
    return genome[idx.long()]


# Instructions an element, counted from probes.cu and charged where the
# function needs them: a counter-hash uniform 14 integer and 1 float (the
# megakernel's count); XLA's log 6 integer and 18 float, a correctly
# rounded sqrt 1 and 5; glibc's cosf on the |y| >= 0.75 path 22 double
# (the reduction, the polynomial and the conversions) and 8 integer; the
# rastrigin term 5 float beside its cos; the chain 24 float.
_HASH = (14, 1, 0)
_LOG, _SQRT, _COS = (6, 18, 0), (1, 5, 0), (8, 0, 22)


def kernel_bound(kind: str, pop: int, dim: int = DIM):
    """``(ms, by)`` of P1–P4 at ``pop`` rows: each input byte read once,
    each output byte written once, against the instructions above."""
    elems = pop * LANE
    if kind == "stream":
        return bound_ms(2 * 4 * elems)
    if kind == "chain":
        return bound_ms(2 * 4 * elems, flts=24 * elems)
    if kind == "rast":          # the live lanes read, a sum a row written
        n = pop * dim
        return bound_ms(4 * n + 4 * pop, ints=_COS[0] * n,
                        flts=5 * n, dbls=_COS[2] * n)
    if kind == "rng":
        per = [2 * h + lg + sq + c + f for h, lg, sq, c, f in
               zip(_HASH, _LOG, _SQRT, _COS, (0, 4, 0))]
        return bound_ms(4 * elems + 4, *(p * elems for p in per))
    if kind == "lookup":
        return bound_ms(3 * 4 * pop)
    if kind == "dmagather":
        return bound_ms(2 * 4 * elems + 4 * pop)
    raise ValueError(f"no bound for {kind!r}")


# ---------------------------------------------------------------------------
# the probes
# ---------------------------------------------------------------------------


def _key(seed: int, run: ProbeRun):
    return random.PRNGKey(seed, device=run.device)


def gidx_table(pop: int, device=None) -> torch.Tensor:
    """``gidx``'s table: ``permutation(split(PRNGKey(0))[1], pop)``, as
    the JAX tool draws it."""
    return random.permutation(random.split(random.PRNGKey(
        0, device=device))[1], pop)


def lookup_table(pop: int, device=None) -> torch.Tensor:
    """``lookup``'s table: ``permutation(PRNGKey(0), pop)``, as the JAX
    tool draws it."""
    return random.permutation(random.PRNGKey(0, device=device), pop)


def probe_sort(run: ProbeRun) -> None:
    pop = run.pop
    keys = random.uniform(_key(0, run), (pop,))

    def step(c):
        order = torch.argsort(c)
        return c + order[0].to(torch.float32) * 1e-30

    run.report("torch_sort_argsort_f32_1m", *run.marginal(step, keys),
               "torch")
    ints = random.randint(_key(1, run), (pop,), 0, pop)

    def step_i(c):
        s = torch.sort(c).values
        return (c + s[0] % 2 + 1) % pop

    run.report("torch_sort_i32_1m", *run.marginal(step_i, ints), "torch")


def probe_gidx(run: ProbeRun) -> None:
    pop = run.pop
    kp = random.split(_key(0, run))[0]
    order = gidx_table(pop, run.device)
    pos = random.randint(kp, (pop,), 0, pop)

    def variant(name, get, **extra):
        def step(p):
            return (p + get(p) + 1) % pop
        run.report(name, *run.marginal(step, pos), "torch", **extra)

    variant("torch_gidx_plain", lambda p: order[p.long()])
    variant("torch_gidx_take", lambda p: torch.take(order, p.long()))
    variant("torch_gidx_sorted_incl_sort",
            lambda p: order[torch.sort(p).values.long()],
            note="subtract torch_sort_i32_1m for the gather alone")


def probe_grow(run: ProbeRun) -> None:
    pop = run.pop
    kg, ki = random.split(_key(0, run))

    def variant(name, dim, dtype, get, idx=None, nxt=None):
        genome = random.uniform(kg, (pop, dim)).to(dtype)
        if idx is None:
            idx = random.randint(ki, (pop,), 0, pop)
        nxt = nxt or (lambda p, r: (p + 1 + (r[:, 0] > 0.5).int()) % pop)

        def step(c):
            g, p = c
            rows = get(g, p)
            return rows, nxt(p, rows)

        sec, r = run.marginal(step, (genome, idx))
        gb = pop * dim * genome.element_size() * 2 / 1e9
        run.report(name, sec, r, "torch", eff_gbps=gb / sec)

    def select(g, p):
        return torch.index_select(g, 0, p)

    variant("torch_grow_plain_d100", run.dim, torch.float32,
            lambda g, p: g[p.long()])
    variant("torch_grow_pib_d100", run.dim, torch.float32, select)
    variant("torch_grow_pib_d128", LANE, torch.float32, select)
    variant("torch_grow_pib_d100_bf16", run.dim, torch.bfloat16, select)
    # monotone (sorted, with repeats) rows: selection by sorted order
    # statistics reads a rank-ordered genome near-sequentially
    sidx = torch.sort(random.randint(ki, (pop,), 0, pop)).values
    variant("torch_grow_sorted_d128", LANE, torch.float32, select, idx=sidx,
            nxt=lambda p, r: torch.clamp(p + 1 + (r[:, 0] > 2.0).int(),
                                         max=pop - 1))


def _rastrigin_rows(x):
    return 10.0 * x.shape[-1] + torch.sum(
        x * x - 10.0 * torch.cos(2.0 * np.pi * x), dim=-1)


def probe_varveval(run: ProbeRun) -> None:
    pop, dim = run.pop, run.dim
    genome = random.uniform(_key(0, run), (pop, dim), minval=-5.12,
                            maxval=5.12)
    n2 = pop // 2
    cols = torch.arange(dim, device=run.device)[None, :]

    def step(c):
        g, key = c
        key, kc, kx, km, kn = random.split(key, 5)
        ga, gb = g[:n2], g[n2:]
        do_cx = random.bernoulli(kc, 0.9, (n2, 1))
        c1 = random.randint(kx, (n2, 1), 1, dim + 1)
        c2 = random.randint(random.fold_in(kx, 1), (n2, 1), 1, dim)
        c2 = torch.where(c2 >= c1, c2 + 1, c2)
        lo, hi = torch.minimum(c1, c2), torch.maximum(c1, c2)
        sw = do_cx & (cols >= lo) & (cols < hi)
        g2 = torch.cat([torch.where(sw, gb, ga), torch.where(sw, ga, gb)])
        mrow = random.bernoulli(km, 0.5, (pop, 1))
        mgen = random.bernoulli(random.fold_in(km, 1), 0.05, (pop, dim))
        noise = 0.3 * random.normal(kn, (pop, dim))
        g2 = torch.where(mrow & mgen, g2 + noise, g2)
        _rastrigin_rows(g2).min()
        return g2, key

    for prng in ("threefry2x32", "rbg"):
        with random.default_impl(prng):
            key = _key(7, run)
        sec, r = run.marginal(step, (genome, key),
                              k=min(VARVEVAL_K, run.k_iters))
        run.report(f"torch_varveval_{prng}", sec, r, "torch")


def probe_stream(run: ProbeRun) -> None:
    x = random.uniform(_key(0, run), (run.pop, LANE))
    gb = run.pop * LANE * 4 * 2 / 1e9
    b, by = kernel_bound("stream", run.pop)
    for rows in (512, 2048, 8192):
        sec, r = run.marginal(lambda c, rows=rows: stream(c, rows), x)
        run.report(f"{run.route}_stream_rows{rows}", sec, r, run.route,
                   eff_gbps=gb / sec, bound_ms=b, bound_by=by)


def probe_chain(run: ProbeRun) -> None:
    x = random.uniform(_key(0, run), (run.pop, LANE))
    sec, r = run.marginal(chain24, x)
    b, by = kernel_bound("chain", run.pop)
    run.report(f"{run.route}_chain24", sec, r, run.route,
               g_elem_ops_per_s=run.pop * LANE * 24 / sec / 1e9,
               bound_ms=b, bound_by=by)


def probe_rng(run: ProbeRun) -> None:
    pop = run.pop

    def step(s):
        out = hash_normal(s, pop)
        return s + 1 + (out[0, :1] > 0).int()

    seed = torch.zeros((1,), dtype=torch.int32, device=run.device)
    sec, r = run.marginal(step, seed)
    b, by = kernel_bound("rng", pop)
    run.report(f"{run.route}_hash_normal_1m_x128", sec, r, run.route,
               g_normals_per_s=pop * LANE / sec / 1e9, bound_ms=b,
               bound_by=by)


def probe_rast(run: ProbeRun) -> None:
    x = random.uniform(_key(0, run), (run.pop, LANE))

    def step(c):
        rast_reduce(c, run.dim)
        return c * _F32_CHAIN

    sec, r = run.marginal(step, x)
    b, by = kernel_bound("rast", run.pop, run.dim)
    run.report(f"{run.route}_rastrigin_reduce", sec, r, run.route,
               eff_read_gbps=run.pop * LANE * 4 / sec / 1e9, bound_ms=b,
               bound_by=by)


def probe_lookup(run: ProbeRun) -> None:
    pop = run.pop
    order = lookup_table(pop, run.device)
    pos = random.randint(_key(1, run), (pop,), 0, pop)

    def step(p):
        return (p + lookup(order, p) + 1) % pop

    sec, r = run.marginal(step, pos)
    b, by = kernel_bound("lookup", pop)
    run.report(f"{run.route}_lookup_l2_scalar", sec, r, run.route,
               m_lookups_per_s=pop / sec / 1e6, bound_ms=b, bound_by=by)


def probe_dmagather(run: ProbeRun) -> None:
    pop = run.pop
    genome = random.uniform(_key(0, run), (pop, LANE))
    idx = random.randint(_key(1, run), (pop,), 0, pop)

    def step(c):
        g, p = c
        out = row_gather(g, p)
        return out, (p + 1 + (out[:, 0] > 0.5).int()) % pop

    sec, r = run.marginal(step, (genome, idx))
    b, by = kernel_bound("dmagather", pop)
    run.report(f"{run.route}_dmagather_rows512_w16", sec, r,
               run.route, m_rows_per_s=pop / sec / 1e6,
               eff_gbps=pop * LANE * 4 * 2 / sec / 1e9, bound_ms=b,
               bound_by=by)


@contextlib.contextmanager
def _pinned(array: np.ndarray, device: torch.device):
    """``array`` as a tensor, page-locked for the card while the block
    runs (unpinned after: nothing stays pinned in a caching allocator)."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        yield t
        return
    rt = torch.cuda.cudart()
    rc = int(rt.cudaHostRegister(t.data_ptr(), array.nbytes, 0))
    if rc != 0:
        raise RuntimeError(f"cudaHostRegister failed ({rc})")
    try:
        yield t
    finally:
        torch.cuda.synchronize(device)
        rt.cudaHostUnregister(t.data_ptr())


def probe_hoststream(run: ProbeRun, rows: int = 8192) -> None:
    pop, dev = run.pop, run.device
    rng = np.random.default_rng(0)
    for tag, make_host in (
            ("f32", lambda: rng.random((pop, LANE), np.float32)),
            ("int8", lambda: rng.integers(-127, 128, (pop, LANE), np.int8))):
        host_np = make_host()
        gb = host_np.nbytes / 1e9                 # one full-pop pass
        with _pinned(host_np, dev) as host, \
                _pinned(np.empty_like(host_np), dev) as drain:
            card = torch.empty(host.shape, dtype=host.dtype, device=dev)

            def h2d():
                for a in range(0, pop, rows):
                    card[a:a + rows].copy_(host[a:a + rows], non_blocking=True)

            sec, r = run.timed(h2d, 4)
            run.report(f"hoststream_h2d_{tag}_rows{rows}", sec, r, "torch",
                       eff_gbps=gb / sec)

            def d2h():
                for a in range(0, pop, rows):
                    drain[a:a + rows].copy_(card[a:a + rows],
                                            non_blocking=True)

            sec, r = run.timed(d2h, 4)
            run.report(f"hoststream_d2h_{tag}_rows{rows}", sec, r, "torch",
                       eff_gbps=gb / sec)
            # the gather the resident engine does instead of streaming
            idx = torch.from_numpy(rng.integers(0, pop, pop).astype(
                np.int32)).to(dev)
            sec, r = run.timed(lambda: torch.index_select(card, 0, idx), 4)
            run.report(f"hoststream_devgather_{tag}", sec, r, "torch",
                       eff_gbps=gb * 2 / sec)
            del card, idx
    if dev.type == "cuda":
        torch.cuda.empty_cache()


PROBES = {
    "sort": probe_sort,
    "gidx": probe_gidx,
    "grow": probe_grow,
    "varveval": probe_varveval,
    "stream": probe_stream,
    "chain": probe_chain,
    "rng": probe_rng,
    "rast": probe_rast,
    "lookup": probe_lookup,
    "dmagather": probe_dmagather,
    "hoststream": probe_hoststream,
}


def recommend_defaults(records, platform: str) -> dict:
    """The gather ``fused_generation`` would take on this backend, with
    the probe rows that decided it: ``"dma"`` (K2) when the P4 kernel's
    GB/s reach ``index_select``'s at d128, else ``"host"``
    (``index_select``, then K1)."""
    by = {r["probe"]: r for r in records}
    rec = {"platform": platform, "gather": "host", "basis": []}
    if platform != "gpu":
        rec["basis"].append(
            "no card: the walls are the plain versions' on the host, not "
            "a measurement of a kernel -> gather='host', the route a CPU "
            "tensor takes")
        return rec
    dma = next((by[n] for n in by if n.startswith("cuda_dmagather_")), None)
    lib = by.get("torch_grow_pib_d128")
    if dma and lib:
        d, x = float(dma["eff_gbps"]), float(lib["eff_gbps"])
        rec["gather"] = "dma" if d >= x else "host"
        rec["basis"].append(
            f"gather wall: {dma['probe']} {d} GB/s vs {lib['probe']} "
            f"(index_select) {x} GB/s -> gather={rec['gather']!r}")
    else:
        rec["gather"] = "dma"
        rec["basis"].append(
            "gather probes not in this run subset -> gather='dma' (the "
            "port's default) unmeasured")
    return rec


def main(argv=None) -> dict:
    """Run the probes; returns the run's document (``--json``'s shape)."""
    ap = argparse.ArgumentParser(
        prog="python -m deap_tpu_torch.probes.ga",
        description="Stage-level probes for the flagship GA generation "
                    "(PyTorch library calls + the port's probe kernels).")
    ap.add_argument("probes", nargs="*",
                    help=f"probe subset (default: all of "
                         f"{', '.join(PROBES)})")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the run as one JSON document")
    ap.add_argument("--recommend", action="store_true",
                    help="fold the gather probes into the recommended "
                         "gather of fused_generation on this backend")
    ap.add_argument("--pop", type=int, default=POP,
                    help=f"population (default {POP})")
    ap.add_argument("--dim", type=int, default=DIM,
                    help=f"genome dim (default {DIM})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.probes if n not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown} (have: {', '.join(PROBES)})")
    run = ProbeRun(args.device, pop=args.pop, dim=args.dim, k_iters=K_ITERS)

    print(json.dumps({"platform": run.platform, "device": run.device_line,
                      "pop": run.pop, "dim": run.dim}), flush=True)
    for n in args.probes or list(PROBES):
        try:
            PROBES[n](run)
        except Exception as e:                      # keep probing
            run.error(n, e)

    result = {"platform": run.platform, "device": run.device_line,
              "pop": run.pop, "dim": run.dim, "k_iters": run.k_iters,
              "probes": run.records, "errors": run.errors,
              "note": ("marginal (t2k-tk)/k per probe with the t2k/tk "
                       "linearity witness, host clock around synchronized "
                       f"runs, the median of {PAIRS} pairs after a warm "
                       "pair; derived rates from the probe's own byte "
                       "accounting; bound_ms is the least time of a probe "
                       "kernel's work at the data-sheet peaks; errors "
                       "record probes this backend cannot run (never "
                       "fabricated numbers)")}
    if args.recommend:
        result["recommend"] = recommend_defaults(run.records, run.platform)
        print(json.dumps({"recommend": result["recommend"]}), flush=True)
    cmd = " ".join(argv if argv is not None else sys.argv[1:])
    doc = {"cmd": f"python -m deap_tpu_torch.probes.ga {cmd}".rstrip(),
           "result": result}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    return doc


if __name__ == "__main__":
    main()
