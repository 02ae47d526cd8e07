"""Launch wrappers of the port's hand-written CUDA kernels.

The library is built from ``megakernel.cu``, ``dominance.cu``,
``gp_interp.cu``, ``hypervolume.cu`` and ``probes.cu`` at first use
(:mod:`deap_tpu_torch.kernels.build`) and bound with ``ctypes``.  A
launcher checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream, and
raises :class:`KernelLaunchError` if ``cudaGetLastError`` reports one.
Only then does it add one to its entry of :data:`LAUNCHES` — the count a
run reads to show that its path really went through the kernel.  Nothing
here falls back to a plain version: that choice is made from the
tensor's device by the callers in ``deap_tpu_torch/ops/generation.py``,
``deap_tpu_torch/ops/dominance.py``, ``deap_tpu_torch/gp/interp.py``,
``deap_tpu_torch/ops/hypervolume.py`` and the probe tools
(``deap_tpu_torch/probes/ga.py``, ``deap_tpu_torch/probes/gp.py``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["LAUNCHES", "KernelLaunchError", "reset_launches", "load",
           "launch_vary", "launch_gather_vary", "launch_var_or",
           "launch_rows_dominate_counts", "launch_gp_interp",
           "launch_hv3d_sweep", "hv3d_chunks", "launch_probe_stream_copy",
           "launch_probe_chain24", "launch_probe_rast_reduce",
           "launch_probe_hash_normal", "launch_probe_lookup",
           "launch_probe_row_gather", "launch_probe_gp", "PROBE_GP_MODES"]

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"megakernel_vary": 0, "megakernel_gather_vary": 0,
            "megakernel_var_or": 0, "rows_dominate_counts": 0,
            "gp_interp": 0, "hv3d_sweep": 0,
            "probe_stream_copy": 0, "probe_chain24": 0,
            "probe_rast_reduce": 0, "probe_hash_normal": 0,
            "probe_lookup": 0, "probe_row_gather": 0, "probe_gp": 0}
#: probes.cu's ``Mode`` of the stripped token loop (P5)
PROBE_GP_MODES = {"noswitch": 0, "dispatch": 1, "stackrw": 2}
_PROBE_LANES = 128
_DTYPES = {"float32": (0, torch.float32), "bfloat16": (1, torch.bfloat16),
           "int8": (2, torch.int8)}
_lib = None
_lock = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused or reported a CUDA error."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from .build import build
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
            lib.megakernel_vary.argtypes = [p, p, ll, i, i, f, f, p, p, ll, p]
            lib.megakernel_vary.restype = i
            lib.megakernel_gather_vary.argtypes = [p, p, p, p, p, ll, i, i,
                                                   f, f, p, p, ll, p]
            lib.megakernel_gather_vary.restype = i
            lib.megakernel_var_or.argtypes = [p, p, p, p, p, ll, i, i, f, p,
                                              p, p]
            lib.megakernel_var_or.restype = i
            lib.rows_dominate_counts.argtypes = [p, p, p, ll, ll, i, p]
            lib.rows_dominate_counts.restype = i
            lib.gp_interp.argtypes = [p, p, p, p, p, p, i, p, ll, i, i, i, p,
                                      p]
            lib.gp_interp.restype = i
            lib.hv3d_sweep.argtypes = [p, p, p, p, ctypes.c_double, p, i, i,
                                       i, i, i, p, p, p, p, i, p]
            lib.hv3d_sweep.restype = i
            lib.probe_stream_copy.argtypes = [p, p, ll, i, p]
            lib.probe_chain24.argtypes = [p, p, ll, p]
            lib.probe_rast_reduce.argtypes = [p, p, ll, i, p]
            lib.probe_hash_normal.argtypes = [p, p, ll, p]
            lib.probe_lookup.argtypes = [p, p, p, ll, p]
            lib.probe_row_gather.argtypes = [p, p, p, ll, p]
            lib.probe_gp.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p]
            u = ctypes.c_uint
            lib.cos_reduced_sweep.argtypes = [u, u, u, p, p, p]
            for name in ("probe_stream_copy", "probe_chain24",
                         "probe_rast_reduce", "probe_hash_normal",
                         "probe_lookup", "probe_row_gather", "probe_gp",
                         "cos_reduced_sweep"):
                getattr(lib, name).restype = i
            lib.megakernel_error_string.argtypes = [i]
            lib.megakernel_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _storage_args(dtype: str, scale: float):
    code, tdt = _DTYPES[dtype]
    return code, tdt, float(np.float32(scale)), float(np.float32(1.0 / scale))


def _raise_on(lib, rc: int, kernel: str):
    if rc != 0:
        msg = lib.megakernel_error_string(rc).decode()
        raise KernelLaunchError(f"{kernel} launch failed: {msg} ({rc})")


def launch_vary(parents, seed, knobs, *, dim: int, dtype: str, scale: float,
                row_base0: int = 0) -> torch.Tensor:
    """K1 on the card: ``(n, dim)`` parents in storage dtype → varied rows."""
    code, tdt, s, inv = _storage_args(dtype, scale)
    n = parents.shape[0]
    _check(parents, "parents", tdt, (n, dim))
    _check(seed, "seed", torch.int32, (1,) if seed.ndim else ())
    _check(knobs, "knobs", torch.float32, (5,))
    if n % 32:
        raise ValueError(f"rows {n} must be a multiple of 32")
    out = torch.empty_like(parents)
    lib = load()
    stream = torch.cuda.current_stream(parents.device).cuda_stream
    with torch.cuda.device(parents.device):
        rc = lib.megakernel_vary(parents.data_ptr(), out.data_ptr(), n, dim,
                                 code, s, inv, seed.data_ptr(),
                                 knobs.data_ptr(), row_base0, stream)
    _raise_on(lib, rc, "megakernel_vary")
    LAUNCHES["megakernel_vary"] += 1
    return out


def launch_gather_vary(order, pos, genome, seed, knobs, *, dim: int,
                       dtype: str, scale: float, row_base0: int = 0):
    """K2 on the card: winners ``order[pos]`` gathered from ``genome`` and
    varied.  Returns ``(new_genome (out_n, dim), widx (out_n,) int32)``."""
    code, tdt, s, inv = _storage_args(dtype, scale)
    pop = genome.shape[0]
    out_n = pos.shape[0]
    _check(genome, "genome", tdt, (pop, dim))
    _check(order, "order", torch.int32, (pop,))
    _check(pos, "pos", torch.int32, (out_n,))
    _check(seed, "seed", torch.int32, (1,) if seed.ndim else ())
    _check(knobs, "knobs", torch.float32, (5,))
    if out_n % 32:
        raise ValueError(f"rows {out_n} must be a multiple of 32")
    out = torch.empty((out_n, dim), dtype=tdt, device=genome.device)
    widx = torch.empty((out_n,), dtype=torch.int32, device=genome.device)
    lib = load()
    stream = torch.cuda.current_stream(genome.device).cuda_stream
    with torch.cuda.device(genome.device):
        rc = lib.megakernel_gather_vary(
            order.data_ptr(), pos.data_ptr(), genome.data_ptr(),
            out.data_ptr(), widx.data_ptr(), out_n, dim, code, s, inv,
            seed.data_ptr(), knobs.data_ptr(), row_base0, stream)
    _raise_on(lib, rc, "megakernel_gather_vary")
    LAUNCHES["megakernel_gather_vary"] += 1
    return out, widx


def launch_var_or(genome, ia, i2, code, seed, knobs, *, dim: int, dtype: str,
                  scale: float) -> torch.Tensor:
    """K3 on the card: per row ``r`` the OR choice ``code[r]`` over
    parents ``genome[ia[r]]`` / ``genome[i2[r]]`` → ``(lambda, dim)`` in
    the storage dtype."""
    dt_code, tdt, s, _ = _storage_args(dtype, scale)
    n = genome.shape[0]
    lam = code.shape[0]
    _check(genome, "genome", tdt, (n, dim))
    for t, name in ((ia, "ia"), (i2, "i2"), (code, "code")):
        _check(t, name, torch.int32, (lam,))
    _check(seed, "seed", torch.int32, (1,) if seed.ndim else ())
    _check(knobs, "knobs", torch.float32, (3,))
    out = torch.empty((lam, dim), dtype=tdt, device=genome.device)
    lib = load()
    stream = torch.cuda.current_stream(genome.device).cuda_stream
    with torch.cuda.device(genome.device):
        rc = lib.megakernel_var_or(
            genome.data_ptr(), ia.data_ptr(), i2.data_ptr(), code.data_ptr(),
            out.data_ptr(), lam, dim, dt_code, s, seed.data_ptr(),
            knobs.data_ptr(), stream)
    _raise_on(lib, rc, "megakernel_var_or")
    LAUNCHES["megakernel_var_or"] += 1
    return out


def launch_rows_dominate_counts(rows, w) -> torch.Tensor:
    """K4 on the card: ``out[j] = #{r : rows[r] dominates w[j]}`` for
    float32 ``rows`` ``(C, m)`` and ``w`` ``(n, m)`` → ``(n,)`` int32."""
    n, m = w.shape
    _check(w, "w", torch.float32)
    _check(rows, "rows", torch.float32, (rows.shape[0], m))
    out = torch.empty((n,), dtype=torch.int32, device=w.device)
    lib = load()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    with torch.cuda.device(w.device):
        rc = lib.rows_dominate_counts(rows.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), rows.shape[0], n, m,
                                      stream)
    _raise_on(lib, rc, "rows_dominate_counts")
    LAUNCHES["rows_dominate_counts"] += 1
    return out


def launch_gp_interp(codes, consts, lengths, X, op_kind,
                     arg_index) -> torch.Tensor:
    """K6 on the card: ``(pop, n_points)`` float32 values of the prefix
    programs ``codes``/``consts`` ``(pop, cap)`` with ``lengths``
    ``(pop,)`` over ``X`` ``(n_args, n_points)``; ``op_kind`` and
    ``arg_index`` ``(n_nodes,)`` int32 map a node code to its opcode and
    its argument row."""
    pop, cap = codes.shape
    n_args, n_points = X.shape
    n_nodes = op_kind.shape[0]
    _check(codes, "codes", torch.int32, (pop, cap))
    _check(consts, "consts", torch.float32, (pop, cap))
    _check(lengths, "lengths", torch.int32, (pop,))
    _check(X, "X", torch.float32, (n_args, n_points))
    _check(op_kind, "op_kind", torch.int32, (n_nodes,))
    _check(arg_index, "arg_index", torch.int32, (n_nodes,))
    out = torch.empty((pop, n_points), dtype=torch.float32, device=X.device)
    next_item = torch.empty((1,), dtype=torch.int32, device=X.device)
    lib = load()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.gp_interp(codes.data_ptr(), consts.data_ptr(),
                           lengths.data_ptr(), X.data_ptr(),
                           op_kind.data_ptr(), arg_index.data_ptr(), n_nodes,
                           out.data_ptr(), pop, cap, n_args, n_points,
                           next_item.data_ptr(), stream)
    _raise_on(lib, rc, "gp_interp")
    LAUNCHES["gp_interp"] += 1
    return out


#: hypervolume.cu's prefixes a warp, and the warps an SM should hold
HV3D_GROUP = 256
HV3D_WARPS_PER_SM = 12
#: the shortest j chunk worth a warp of its own
HV3D_MIN_CHUNK = 256


_SMS: dict = {}


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def hv3d_chunks(n: int, sms: int, count: int | None = None) -> int:
    """How many pieces K5 splits the j range into: enough warps (one per
    256 of the ``count`` prefixes swept, default ``n``, and chunk) for
    :data:`HV3D_WARPS_PER_SM` on each of ``sms`` SMs, with chunks of at
    least :data:`HV3D_MIN_CHUNK` of the ``n`` slots."""
    groups = -(-(n if count is None else count) // HV3D_GROUP)
    want = -(-HV3D_WARPS_PER_SM * sms // groups)
    return max(1, min(want, n // HV3D_MIN_CHUNK, 65535))


def launch_hv3d_sweep(ys, zr, width, dz, ref_y: float,
                      threads: int = 128, k_begin: int = 0,
                      count: int | None = None) -> torch.Tensor:
    """K5 on the card: the blocked staircase sweep over the x-sorted view
    ``ys``/``zr``/``width`` and the strip depths ``dz`` (all ``(n,)``;
    float32 or float64, ``zr`` int32), over the prefixes ``k_begin < k
    <= k_begin + count`` (default: all ``n``; prefixes past ``n`` add
    nothing).  Returns one partial volume per block of ``threads`` of
    those prefixes, ``(ceil(count / threads),)``; their sum is the
    range's volume (the hypervolume for the whole range).  The j range
    is split into :func:`hv3d_chunks` pieces; the scratch is allocated
    here."""
    n = ys.shape[0]
    count = n - int(k_begin) if count is None else int(count)
    if not 0 <= k_begin < n or count < 1:
        raise ValueError(f"prefix range [{k_begin}, {k_begin + count}) "
                         f"of {n}")
    if ys.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ys dtype {ys.dtype} is not float32 or float64")
    if not 0 < n < (1 << 31) - 1024:
        raise ValueError(f"n = {n} out of range")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"threads {threads} must be a multiple of 32 in "
                         "[32, 1024]")
    _check(ys, "ys", ys.dtype, (n,))
    _check(zr, "zr", torch.int32, (n,))
    _check(width, "width", ys.dtype, (n,))
    _check(dz, "dz", ys.dtype, (n,))
    dev = ys.device
    chunks = hv3d_chunks(n, _sm_count(dev), count)
    out = torch.empty((-(-count // threads),), dtype=ys.dtype, device=dev)
    # one scratch allocation, in elements of ys's dtype: area (chunks,
    # count) and, when the j range is split, gm (chunks, groups), hz (n,)
    # and the int32 cz (n,) (8-byte aligned: every part is a whole number
    # of elements of at least 4 bytes, cz last)
    elt = ys.element_size()
    parts = [chunks * count]
    if chunks > 1:
        parts += [chunks * -(-n // HV3D_GROUP), n, -(-n * 4 // elt)]
    scratch = torch.empty((sum(parts),), dtype=ys.dtype, device=dev)
    ptrs, at = [], scratch.data_ptr()
    for k in parts:
        ptrs.append(at)
        at += k * elt
    ptrs += [0] * (4 - len(ptrs))
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.hv3d_sweep(ys.data_ptr(), zr.data_ptr(), width.data_ptr(),
                            dz.data_ptr(), float(ref_y), out.data_ptr(), n,
                            int(k_begin), count, threads, chunks, *ptrs,
                            int(ys.dtype == torch.float64), stream)
    _raise_on(lib, rc, "hv3d_sweep")
    LAUNCHES["hv3d_sweep"] += 1
    return out


def _launch_rows(name: str, x, *extra) -> torch.Tensor:
    n = x.shape[0]
    _check(x, "x", torch.float32, (n, _PROBE_LANES))
    out = torch.empty_like(x)
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(x.data_ptr(), out.data_ptr(), n, *extra,
                                stream)
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def launch_probe_stream_copy(x, *, rows: int) -> torch.Tensor:
    """P1's copy on the card: ``(n, 128)`` float32 through the bulk copier
    (TMA), the grid cut into tiles of ``rows`` rows.  The bulk copies
    need 16-byte aligned addresses: a view that starts elsewhere is
    refused."""
    if rows < 1:
        raise ValueError(f"rows {rows} must be at least 1")
    if x.is_cuda and x.data_ptr() % 16:
        raise ValueError("the bulk copy needs a 16-byte aligned x (got "
                         f"address {x.data_ptr():#x})")
    return _launch_rows("probe_stream_copy", x, rows)


def launch_probe_chain24(x) -> torch.Tensor:
    """P1's chain on the card: 24 times ``fma(v, 1.0000001, 1e-7)``."""
    return _launch_rows("probe_chain24", x)


def launch_probe_rast_reduce(x, *, dim: int) -> torch.Tensor:
    """P1's reduce on the card: ``(n, 128)`` float32 → ``(n,)``, the
    rastrigin term of lanes ``< dim`` summed in XLA's order."""
    n = x.shape[0]
    _check(x, "x", torch.float32, (n, _PROBE_LANES))
    if not 0 <= dim <= _PROBE_LANES:
        raise ValueError(f"dim {dim} outside [0, {_PROBE_LANES}]")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.probe_rast_reduce(x.data_ptr(), out.data_ptr(), n, dim,
                                   stream)
    _raise_on(lib, rc, "probe_rast_reduce")
    LAUNCHES["probe_rast_reduce"] += 1
    return out


def launch_probe_hash_normal(seed, n_rows: int) -> torch.Tensor:
    """P2 on the card: ``(n_rows, 128)`` float32 normals from the counter
    hash of ``seed`` (``(1,)`` int32 on the card), draws 6 and 7."""
    _check(seed, "seed", torch.int32, (1,))
    if not 0 <= n_rows <= 1 << 32:
        raise ValueError(f"n_rows {n_rows} outside [0, 2**32]")
    out = torch.empty((n_rows, _PROBE_LANES), dtype=torch.float32,
                      device=seed.device)
    lib = load()
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        rc = lib.probe_hash_normal(seed.data_ptr(), out.data_ptr(), n_rows,
                                   stream)
    _raise_on(lib, rc, "probe_hash_normal")
    LAUNCHES["probe_hash_normal"] += 1
    return out


def launch_probe_lookup(order, pos) -> torch.Tensor:
    """P3 on the card: ``order[pos]`` for int32 ``order`` ``(m,)`` and
    ``pos`` ``(n,)``, every position in ``[0, m)`` (not checked)."""
    _check(order, "order", torch.int32, (order.shape[0],))
    _check(pos, "pos", torch.int32, (pos.shape[0],))
    out = torch.empty_like(pos)
    lib = load()
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    with torch.cuda.device(pos.device):
        rc = lib.probe_lookup(order.data_ptr(), pos.data_ptr(),
                              out.data_ptr(), pos.shape[0], stream)
    _raise_on(lib, rc, "probe_lookup")
    LAUNCHES["probe_lookup"] += 1
    return out


def launch_probe_row_gather(genome, idx) -> torch.Tensor:
    """P4 on the card: ``genome[idx]`` for ``(m, 128)`` float32 rows and
    int32 ``idx`` ``(n,)``, every index in ``[0, m)`` (not checked); a
    block owns 512 output rows and a warp keeps 16 rows in flight."""
    _check(genome, "genome", torch.float32, (genome.shape[0], _PROBE_LANES))
    _check(idx, "idx", torch.int32, (idx.shape[0],))
    out = torch.empty((idx.shape[0], _PROBE_LANES), dtype=torch.float32,
                      device=idx.device)
    lib = load()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    with torch.cuda.device(idx.device):
        rc = lib.probe_row_gather(genome.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), idx.shape[0], stream)
    _raise_on(lib, rc, "probe_row_gather")
    LAUNCHES["probe_row_gather"] += 1
    return out


def launch_probe_gp(codes, consts, lengths, *, n_points: int, mode: str,
                    tb: int, unroll: bool, n_branches: int) -> torch.Tensor:
    """P5 on the card: the stripped token loop (``mode`` one of
    :data:`PROBE_GP_MODES`) over ``codes``/``consts`` ``(pop, cap)`` with
    ``lengths`` ``(pop,)``, ``tb`` trees a block, unrolled over 63 tokens
    or not → ``(pop, n_points)`` float32."""
    pop, cap = codes.shape
    _check(codes, "codes", torch.int32, (pop, cap))
    _check(consts, "consts", torch.float32, (pop, cap))
    _check(lengths, "lengths", torch.int32, (pop,))
    out = torch.empty((pop, n_points), dtype=torch.float32,
                      device=codes.device)
    lib = load()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    with torch.cuda.device(codes.device):
        rc = lib.probe_gp(codes.data_ptr(), consts.data_ptr(),
                          lengths.data_ptr(), out.data_ptr(), pop, cap,
                          n_points, PROBE_GP_MODES[mode], tb, int(unroll),
                          n_branches, stream)
    _raise_on(lib, rc, "probe_gp")
    LAUNCHES["probe_gp"] += 1
    return out


def _cos_reduced_mismatches(lo: int, hi: int, stride: int = 1,
                            device="cuda") -> tuple:
    """``(count, first)``: how many of the float32 bit patterns ``lo, lo +
    stride, ...`` below ``hi`` give other bits through the branch-free
    cosine of ``device_math.cuh`` (``cos_reduced``, P1's and P2's) than
    through ``xla_sincos(y, true)``, and the lowest such pattern (``None``
    when there is none).  A check of the range the kernels claim for it,
    run on the card by the tests and ``chip_smoke.py``; no probe calls
    it, and it counts no launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the cosine sweep runs on a CUDA device (got {dev})")
    if not 0 <= lo <= hi < 1 << 32 or stride < 1:
        raise ValueError(f"bad sweep [{lo}, {hi}) step {stride}")
    bad = torch.zeros((1,), dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cos_reduced_sweep(lo, hi, stride, bad.data_ptr(),
                                   first.data_ptr(), stream)
    _raise_on(lib, rc, "cos_reduced_sweep")
    count = int(bad.item())
    return count, (int(first.item()) & 0xFFFFFFFF) if count else None
