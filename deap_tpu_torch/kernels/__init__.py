"""Launch wrappers of the port's hand-written CUDA kernels.

The library is built from ``megakernel.cu`` at first use
(:mod:`deap_tpu_torch.kernels.build`) and bound with ``ctypes``.  A
launcher checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream, and
raises :class:`KernelLaunchError` if ``cudaGetLastError`` reports one.
Only then does it add one to its entry of :data:`LAUNCHES` — the count a
run reads to show that its path really went through the kernel.  Nothing
here falls back to a plain version: that choice is made from the
tensor's device by the callers in ``deap_tpu_torch/ops/generation.py``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["LAUNCHES", "KernelLaunchError", "reset_launches", "load",
           "launch_vary", "launch_gather_vary"]

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"megakernel_vary": 0, "megakernel_gather_vary": 0}
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
