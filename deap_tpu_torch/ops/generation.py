"""Fused select→mate→mutate generation for the fixed-shape GA, the fused
``var_or`` of the mu±lambda loops and the NSGA-II head, and the
mixed-precision genome storage they ride on — the PyTorch counterpart of
``deap_tpu/ops/generation_pallas.py``.

The generation is the JAX package's, step for step:

* **selection** — the fitness sort stays a library sort (``torch.sort``,
  where the JAX package leaves it to XLA) and the tournament winner
  *positions* come from :func:`~deap_tpu_torch.ops.selection.
  tournament_positions`, so winner indices equal ``sel_tournament(...,
  tie_break="rank")`` under the same key;
* **gather + vary** — one hand-written CUDA kernel per generation on the
  card (``deap_tpu_torch/kernels/megakernel.cu``): K2
  (:func:`megakernel_gather_vary`, ``gather="dma"``, the flagship)
  resolves each row's winner ``order[pos[r]]``, reads that parent row and
  applies the variation; K1 (:func:`megakernel_vary`, ``gather="host"``,
  the serving live-mask form) applies the variation to parents already
  gathered.

The variation is the JAX tile function ``_vary_tile``: row ``i`` mates
row ``i ^ 16`` inside its 32-row block of absolute rows (two-point
crossover, cut law of ``_two_cut_points``), then a per-row gate and a
per-gene mask drawn from one counter hash mutate genes by
``mu + sigma * sqrt(2) * erf_inv(2u/indpb - 1)``.  Every draw is a
``lowbias32``-style hash of ``(seed, draw, row, lane)``, so the stream
is a pure function of global coordinates.  The port works on the
unpadded ``(pop, dim)`` layout (the hash uses coordinates, so lane
padding never changed a value) and needs ``pop % 32 == 0``.

``var_or``'s fused form (:func:`fused_var_or`) keeps ``var_or``'s key
law for the per-row choice and parent indices and runs the operators in
K3 (:func:`megakernel_var_or`, the JAX tile function ``_var_or_tile``:
the first child of a two-point crossover with a partner row, or
Gaussian mutation from one gene grid, draw ids 4 and 5).  The NSGA-II
head (:func:`fused_nsga2_step`) selects with the registered
``sel_nsga2`` and varies with K1.

Each kernel has its plain PyTorch version beside it
(:func:`_vary_tile_plain`, :func:`_gather_vary_plain`,
:func:`_var_or_plain`).  A wrapper runs
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  The arithmetic is the JAX package's to the bit:
integer hashing, masks and cut points exactly, the mutation noise
through XLA's own ``erf_inv`` (:mod:`deap_tpu_torch._xla_math`), with a
fused multiply-add exactly where XLA's CPU backend fuses one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import random
from .._xla_math import erf_inv, fma
from ..base import Fitness, Population, lex_sort_indices
from ..random import M32, mul32
from .selection import tournament_positions

__all__ = ["GenomeStorage", "STORAGE_DTYPES", "HardwareRngUnavailable",
           "fused_generation", "fused_ea_step", "fused_var_or",
           "fused_nsga2_step", "megakernel_params",
           "megakernel_variation_params", "megakernel_vary",
           "megakernel_gather_vary", "megakernel_var_or", "storage_of"]

STORAGE_DTYPES = ("float32", "bfloat16", "int8")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}
#: mating quantum: row i mates row i ^ 16 inside each 32-row block
QUANTUM = 32
_SQRT2 = 1.4142135381698608             # float32(sqrt(2))
_UN_LO = 2.0 ** -25
_UN_HI = float(np.float32(1.0 - 2.0 ** -25))   # rounds to 1.0, as in JAX


class HardwareRngUnavailable(NotImplementedError):
    """``hw_rng=True`` asks for the TPU's hardware PRNG stream, which has
    no counterpart on the card."""


# ---------------------------------------------------------------------------
# genome storage (the mixed-precision tier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GenomeStorage:
    """Declared genome residency: ``dtype`` in :data:`STORAGE_DTYPES`;
    ``bound`` is the symmetric int8 quantization range (``scale = bound /
    127``).  ``bound=127`` gives scale 1, exact for integer genomes in
    [-127, 127]."""

    dtype: str = "float32"
    bound: float = 0.0

    def __post_init__(self):
        if self.dtype not in STORAGE_DTYPES:
            raise ValueError(f"storage dtype {self.dtype!r}: expected one "
                             f"of {STORAGE_DTYPES}")
        if self.dtype == "int8" and not self.bound > 0.0:
            raise ValueError("int8 genome storage needs bound > 0 "
                             "(symmetric quantization range)")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def scale(self) -> float:
        return float(self.bound) / 127.0 if self.dtype == "int8" else 1.0

    @property
    def is_narrow(self) -> bool:
        return self.dtype != "float32"

    def to_storage(self, x: torch.Tensor) -> torch.Tensor:
        """float32 compute values → storage representation."""
        x = x.to(torch.float32)
        if self.dtype == "int8":
            # a true division, as in the JAX package: on the card PyTorch
            # turns a division by a Python scalar into a multiply by its
            # reciprocal, so the divisor is a tensor on x's device
            scale = torch.tensor(float(np.float32(self.scale)),
                                 device=x.device)
            q = torch.round(x / scale)
            return torch.clamp(q, -127.0, 127.0).to(torch.int8)
        return x.to(self.torch_dtype)

    def to_compute(self, x: torch.Tensor) -> torch.Tensor:
        """Storage representation → float32 compute values."""
        return _widen(x, self.dtype, self.scale)


def storage_of(toolbox) -> Optional[GenomeStorage]:
    """``toolbox.genome_storage`` (a :class:`GenomeStorage`) or ``None``."""
    st = getattr(toolbox, "genome_storage", None)
    if st is not None and not isinstance(st, GenomeStorage):
        raise TypeError("toolbox.genome_storage must be a GenomeStorage")
    return st


def _widen(v: torch.Tensor, dtype: str, scale: float) -> torch.Tensor:
    v = v.to(torch.float32)
    if dtype == "int8":
        v = v * float(np.float32(scale))
    return v


def _narrow(v: torch.Tensor, dtype: str, scale: float) -> torch.Tensor:
    if dtype == "int8":
        q = torch.round(v * float(np.float32(1.0 / scale)))
        return torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return v.to(_TORCH_DTYPES[dtype])


# ---------------------------------------------------------------------------
# the counter hash (uint32 words held in int64)
# ---------------------------------------------------------------------------


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = mul32(x, 0x735A2D97)
    return x ^ (x >> 15)


def _uniform_at(useed, draw: int, rows, lanes) -> torch.Tensor:
    """Uniforms in [0, 1) at broadcast (row, lane) coordinates: the hash
    of the coordinates, the call's seed and the draw id."""
    ctr = (mul32(rows, 0x9E3779B9) + mul32(lanes, 0x85EBCA6B)
           + ((draw * 0xC2B2AE35) & M32)) & M32
    bits = _mix32(ctr ^ useed)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _uniform_tile(seed, draw: int, shape, row_base=0) -> torch.Tensor:
    """``(rows, lanes)`` grid of the draw ``draw`` starting at global row
    ``row_base`` (the JAX package's ``_uniform_tile``)."""
    seed = torch.as_tensor(seed)
    rows = torch.arange(shape[0], dtype=torch.int64,
                        device=seed.device)[:, None] + int(row_base)
    lanes = torch.arange(shape[1], dtype=torch.int64, device=seed.device)
    return _uniform_at(seed.to(torch.int64) & M32, draw, rows, lanes[None])


def _seed_from_key(key: torch.Tensor) -> torch.Tensor:
    """One int32 seed word from a raw key: ``k[-1] ^ (k[0] * golden)``."""
    data = key.reshape(-1).to(torch.int64)
    mixed = data[-1] ^ mul32(data[0], 0x9E3779B9)
    return (((mixed + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def _cut_points(u1: torch.Tensor, u2: torch.Tensor, dim: int):
    """The reference ``_two_cut_points`` law on two uniforms: ``c1`` in
    ``[1, dim]``, ``c2`` in ``[1, dim-1]`` bumped past ``c1``, ordered."""
    c1 = torch.clamp(1 + torch.floor(u1 * float(dim)).to(torch.int32),
                     max=dim)
    c2 = torch.clamp(1 + torch.floor(u2 * float(dim - 1)).to(torch.int32),
                     max=dim - 1)
    c2 = torch.where(c2 >= c1, c2 + 1, c2)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


# ---------------------------------------------------------------------------
# the plain versions of the two kernels
# ---------------------------------------------------------------------------


def _vary_tile_plain(v: torch.Tensor, seed: torch.Tensor,
                     knobs: torch.Tensor, dim: int,
                     row_base0: int = 0) -> torch.Tensor:
    """The variation on float32 rows ``v`` of shape ``(n, dim)``, ``n`` a
    multiple of 32, whose first row is global row ``row_base0``:
    crossover of row ``i`` with ``i ^ 16`` from the pair draw at the
    block's a-row, then Gaussian mutation.  ``knobs`` is float32
    ``[cxpb, mutpb, mu, sigma, indpb]``."""
    n, width = v.shape
    if n % QUANTUM or width != dim:
        raise ValueError(f"variation rows {tuple(v.shape)}: need "
                         f"(n, {dim}) with n % {QUANTUM} == 0")
    dev = v.device
    useed = seed.reshape(()).to(torch.int64) & M32
    cxpb, mutpb, mu, sigma, indpb = knobs.to(torch.float32).unbind()
    r = torch.arange(n, dtype=torch.int64, device=dev)
    lanes = torch.arange(width, dtype=torch.int64, device=dev)

    # --- two-point crossover (pair draw 1 at the a-row, lanes 0..2) -------
    a_row = (r & ~16) + row_base0
    u_pair = _uniform_at(useed, 1, a_row[:, None],
                         torch.arange(3, dtype=torch.int64, device=dev)[None])
    lo, hi = _cut_points(u_pair[:, 1:2], u_pair[:, 2:3], dim)
    swap = (u_pair[:, 0:1] < cxpb) & (lanes >= lo) & (lanes < hi)
    v = torch.where(swap, v[r ^ 16], v)

    # --- Gaussian mutation (row gate: draw 2; mask and noise: draw 3) -----
    rows = r + row_base0
    do_mut = _uniform_at(useed, 2, rows, 0) < mutpb
    u_gene = _uniform_at(useed, 3, rows[:, None], lanes[None, :])
    mask = do_mut[:, None] & (u_gene < indpb)
    un = torch.clamp(u_gene[mask] * (1.0 / indpb), _UN_LO, _UN_HI)
    # noise = mu + sigma * (sqrt(2) * erf_inv(.)): XLA multiplies the two
    # scalars first and fuses the rest into one FMA
    noise = fma(erf_inv(2.0 * un - 1.0), sigma * _SQRT2, mu)
    out = v.clone()
    out[mask] = v[mask] + noise
    return out


def _var_or_tile_plain(a: torch.Tensor, b: torch.Tensor, code: torch.Tensor,
                       seed: torch.Tensor, knobs: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """The OR-choice variation on float32 rows (the JAX package's
    ``_var_or_tile`` at absolute row coordinates): row ``r`` with
    ``code[r] == 0`` takes the first child of a two-point crossover of
    ``a[r]`` with ``b[r]`` (cut pair: draw 4 at lanes 0 and 1), with
    ``code[r] == 1`` Gaussian mutation of ``a[r]`` (mask and noise from
    the gene grid of draw 5), else a copy of ``a[r]``.  ``knobs`` is
    float32 ``[mu, sigma, indpb]``."""
    n, width = a.shape
    if width != dim or b.shape != a.shape:
        raise ValueError(f"var_or rows {tuple(a.shape)}/{tuple(b.shape)}: "
                         f"need two (n, {dim})")
    dev = a.device
    useed = seed.reshape(()).to(torch.int64) & M32
    mu, sigma, indpb = knobs.to(torch.float32).unbind()
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    lanes = torch.arange(width, dtype=torch.int64, device=dev)
    code = code.reshape(n, 1)

    # --- two-point crossover, first child kept ----------------------------
    u_cut = _uniform_at(useed, 4, rows[:, None],
                        torch.arange(2, dtype=torch.int64, device=dev)[None])
    lo, hi = _cut_points(u_cut[:, 0:1], u_cut[:, 1:2], dim)
    v = torch.where((code == 0) & (lanes >= lo) & (lanes < hi), b, a)

    # --- Gaussian mutation (mask and noise from one gene grid) ------------
    u_gene = _uniform_at(useed, 5, rows[:, None], lanes[None, :])
    mask = (code == 1) & (u_gene < indpb)
    un = torch.clamp(u_gene[mask] * (1.0 / indpb), _UN_LO, _UN_HI)
    noise = fma(erf_inv(2.0 * un - 1.0), sigma * _SQRT2, mu)
    out = v.clone()
    out[mask] = v[mask] + noise
    return out


def _var_or_plain(genome, ia, i2, code, seed, knobs, dim: int,
                  storage: GenomeStorage):
    """K3's plain version: gather both parents, widen, vary
    (:func:`_var_or_tile_plain`), narrow with ``to_storage``'s law."""
    a = _widen(genome.index_select(0, ia.long()), storage.dtype,
               storage.scale)
    b = _widen(genome.index_select(0, i2.long()), storage.dtype,
               storage.scale)
    return storage.to_storage(_var_or_tile_plain(a, b, code, seed, knobs,
                                                 dim))


def _gather_vary_plain(order, pos, genome, seed, knobs, dim: int,
                       storage: GenomeStorage, row_base0: int = 0):
    """K2's plain version: ``widx = order[pos]``, gather the winners'
    rows, vary them (:func:`_vary_tile_plain`) between widening and
    narrowing.  Returns ``(new_genome, widx)``."""
    widx = order[pos.long()].to(torch.int32)
    parents = _widen(genome.index_select(0, widx.long()), storage.dtype,
                     storage.scale)
    out = _vary_tile_plain(parents, seed, knobs, dim, row_base0)
    return _narrow(out, storage.dtype, storage.scale), widx


# ---------------------------------------------------------------------------
# the kernel wrappers: the plain version on CPU tensors, the kernel on CUDA
# ---------------------------------------------------------------------------


def _check_same_device(*tensors):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"megakernel operands on several devices: {devs}")


def megakernel_vary(parents, seed, knobs, *, dim: int,
                    storage: GenomeStorage, row_base0: int = 0):
    """K1: the variation over gathered ``parents`` ``(n, dim)`` in the
    storage dtype.  CUDA tensors launch ``megakernel_vary`` (replacing
    ``_megakernel_host``, ``deap_tpu/ops/generation_pallas.py``)."""
    _check_same_device(parents, seed, knobs)
    if parents.is_cuda:
        from .. import kernels
        return kernels.launch_vary(parents, seed, knobs, dim=dim,
                                   dtype=storage.dtype,
                                   scale=storage.scale,
                                   row_base0=row_base0)
    v = _widen(parents, storage.dtype, storage.scale)
    out = _vary_tile_plain(v, seed, knobs, dim, row_base0)
    return _narrow(out, storage.dtype, storage.scale)


def megakernel_gather_vary(order, pos, genome, seed, knobs, *, dim: int,
                           storage: GenomeStorage, row_base0: int = 0):
    """K2: winner ``order[pos[r]]`` per output row, the gather of its
    genome row, and K1's variation, in one pass.  Returns ``(new_genome,
    widx)``.  CUDA tensors launch ``megakernel_gather_vary`` (replacing
    ``_megakernel_dma``, ``deap_tpu/ops/generation_pallas.py``)."""
    _check_same_device(order, pos, genome, seed, knobs)
    if genome.is_cuda:
        from .. import kernels
        return kernels.launch_gather_vary(order, pos, genome, seed, knobs,
                                          dim=dim, dtype=storage.dtype,
                                          scale=storage.scale,
                                          row_base0=row_base0)
    return _gather_vary_plain(order, pos, genome, seed, knobs, dim, storage,
                              row_base0)


def megakernel_var_or(genome, ia, i2, code, seed, knobs, *, dim: int,
                      storage: GenomeStorage):
    """K3: per output row the OR choice ``code`` over parent rows
    ``genome[ia]`` (and partner ``genome[i2]``), in the storage dtype.
    CUDA tensors launch ``megakernel_var_or`` (replacing
    ``_var_or_pallas``, ``deap_tpu/ops/generation_pallas.py``), which
    gathers the parent rows itself."""
    _check_same_device(genome, ia, i2, code, seed, knobs)
    if genome.is_cuda:
        from .. import kernels
        return kernels.launch_var_or(genome, ia, i2, code, seed, knobs,
                                     dim=dim, dtype=storage.dtype,
                                     scale=storage.scale)
    return _var_or_plain(genome, ia, i2, code, seed, knobs, dim, storage)


# ---------------------------------------------------------------------------
# the generation
# ---------------------------------------------------------------------------


_KNOBS: dict = {}


def _knobs(values, device) -> torch.Tensor:
    """The float32 knob vector on ``device``, built once per value set:
    a fresh host→device copy every generation would stall the stream."""
    key = (tuple(float(v) for v in values), str(device))
    t = _KNOBS.get(key)
    if t is None:
        if len(_KNOBS) > 64:
            _KNOBS.clear()
        t = _KNOBS[key] = torch.tensor(key[0], dtype=torch.float32,
                                       device=device)
    return t


def fused_generation(k_sel, k_var, genome, wvalues, *, dim: int,
                     cxpb, mutpb, mut_mu=0.0, mut_sigma=0.3, indpb=0.05,
                     tournsize: int = 3,
                     storage: Optional[GenomeStorage] = None,
                     live_n=None, rows: Optional[int] = None,
                     gather: Optional[str] = None, hw_rng: bool = False):
    """One fused GA generation over a ``(pop, dim)`` genome in storage
    representation: tournament-select ``pop`` winners against
    ``wvalues`` (``(pop, nobj)`` float32, ``-inf`` for invalid rows),
    cross and mutate them, and return ``(new_genome, winner_idx)``.

    ``gather="dma"`` (the default) is K2, gather and variation in one
    kernel; ``"host"`` gathers with a tensor index and runs K1.
    ``live_n`` (host only) is the serving live-prefix contract: winners
    remap into the live prefix and pad rows pass through untouched.
    ``rows`` is kept for the JAX signature: the trajectory does not
    depend on it, and it must be a multiple of 32 that divides ``pop``."""
    if hw_rng:
        raise HardwareRngUnavailable(
            "hw_rng=True draws the TPU's hardware PRNG stream, which has "
            "no counterpart on the card; use the counter hash (default)")
    storage = storage or GenomeStorage()
    pop, width = genome.shape
    if genome.dtype != storage.torch_dtype:
        raise ValueError(f"genome dtype {genome.dtype} != declared "
                         f"storage {storage.dtype}")
    if width != dim:
        raise ValueError(f"genome trailing axis {width} != dim {dim} (the "
                         "port runs the unpadded (pop, dim) layout)")
    gather = gather or "dma"
    if gather not in ("dma", "host"):
        raise ValueError(f"gather {gather!r}: expected 'dma' or 'host'")
    if gather == "dma" and live_n is not None:
        raise ValueError("live-masked megakernel steps use gather='host' "
                         "(the serving composition); the dma form is the "
                         "fixed-shape flagship path")
    rows = rows or QUANTUM
    if rows % QUANTUM or pop % rows:
        raise ValueError(f"rows {rows} must be a multiple of {QUANTUM} "
                         f"that divides pop {pop}")

    order = lex_sort_indices(wvalues.to(torch.float32),
                             descending=True).to(torch.int32)
    pos = tournament_positions(k_sel, pop, pop, tournsize)
    seed = _seed_from_key(k_var)
    knobs = _knobs((cxpb, mutpb, mut_mu, mut_sigma, indpb), genome.device)

    if gather == "dma":
        return megakernel_gather_vary(order, pos, genome, seed, knobs,
                                      dim=dim, storage=storage)
    widx = order[pos.long()]
    if live_n is not None:
        live_n = torch.clamp(torch.as_tensor(live_n, device=widx.device),
                             min=1).to(widx.dtype)
        widx = torch.where(widx < live_n, widx, widx % live_n)
    varied = megakernel_vary(genome[widx.long()], seed, knobs, dim=dim,
                             storage=storage)
    if live_n is not None:
        live = torch.arange(pop, device=genome.device)[:, None] < live_n
        varied = torch.where(live, varied, genome)
    return varied, widx


# ---------------------------------------------------------------------------
# algorithm-level integration (the ea_step engine)
# ---------------------------------------------------------------------------


def _base_fn(tool):
    return getattr(tool, "func", tool)


def megakernel_variation_params(toolbox) -> dict:
    """Check the toolbox's variation operators against the fused kernel
    (``cx_two_point`` + ``mut_gaussian``, keyword parameters only) and
    return its mutation knobs."""
    from . import crossover, mutation

    if _base_fn(toolbox.mate) is not crossover.cx_two_point:
        raise ValueError("megakernel generation needs mate=cx_two_point; "
                         f"got {getattr(_base_fn(toolbox.mate), '__name__', '?')}")
    if _base_fn(toolbox.mutate) is not mutation.mut_gaussian:
        raise ValueError("megakernel generation needs mutate=mut_gaussian; "
                         f"got {getattr(_base_fn(toolbox.mutate), '__name__', '?')}")
    for name in ("mate", "mutate"):
        if getattr(getattr(toolbox, name), "args", ()):
            raise ValueError(
                f"megakernel generation: toolbox.{name} froze positional "
                "arguments; register operator parameters as keywords "
                "(tournsize=, mu=, sigma=, indpb=)")
    mut_kw = dict(getattr(toolbox.mutate, "keywords", {}))
    return {"mut_mu": mut_kw.get("mu", 0.0),
            "mut_sigma": mut_kw.get("sigma", 0.3),
            "indpb": mut_kw.get("indpb", 0.05)}


def megakernel_params(toolbox) -> dict:
    """:func:`megakernel_variation_params` plus the selection check:
    ``sel_tournament`` with ``tie_break="rank"`` and keyword
    ``tournsize``."""
    from . import selection as sel_mod

    if _base_fn(toolbox.select) is not sel_mod.sel_tournament:
        raise ValueError("megakernel generation needs "
                         "select=sel_tournament (rank-position law); got "
                         f"{getattr(_base_fn(toolbox.select), '__name__', '?')}")
    params = megakernel_variation_params(toolbox)
    if getattr(toolbox.select, "args", ()):
        raise ValueError(
            "megakernel generation: toolbox.select froze positional "
            "arguments; register operator parameters as keywords "
            "(tournsize=, mu=, sigma=, indpb=)")
    sel_kw = dict(getattr(toolbox.select, "keywords", {}))
    if sel_kw.get("tie_break", "random") != "rank":
        raise ValueError(
            "megakernel generation resolves winners from the rank table: "
            "register select=sel_tournament with tie_break='rank'")
    params["tournsize"] = int(sel_kw.get("tournsize", 3))
    return params


def fused_ea_step(key, population, toolbox, cxpb, mutpb, *, live=None,
                  gather: Optional[str] = None, hw_rng: bool = False):
    """The megakernel form of one ``ea_step`` generation (the toolbox
    declares ``generation_engine = "megakernel"``).  Every produced row
    comes back invalid (reevaluate-all); the key splits three ways as in
    the JAX package.  ``live`` selects ``gather="host"`` (K1)."""
    genome = _two_d_genome(population, "megakernel generation")
    params = megakernel_params(toolbox)
    storage = storage_of(toolbox) or GenomeStorage()
    pop, dim = genome.shape
    if live is not None and gather is None:
        gather = "host"

    key, k_sel, k_var = random.split(key, 3)
    live_n = None
    if live is not None:
        live_n = live.to(torch.int32).sum()
    new_genome, _ = fused_generation(
        k_sel, k_var, genome, population.fitness.masked_wvalues(),
        dim=dim, cxpb=cxpb, mutpb=mutpb, storage=storage,
        tournsize=params["tournsize"], mut_mu=params["mut_mu"],
        mut_sigma=params["mut_sigma"], indpb=params["indpb"],
        live_n=live_n, gather=gather, hw_rng=hw_rng)

    return key, Population(new_genome, _fresh_fitness(population, live))


def _fresh_fitness(population, live=None) -> Fitness:
    """All-invalid fitness for the new rows; with ``live``, pad rows keep
    their old (invalid) values."""
    old = population.fitness
    fit = Fitness.empty(population.size, old.weights, old.values.dtype,
                        old.values.device)
    if live is not None:
        fit = dataclasses.replace(fit, values=torch.where(
            live[:, None], fit.values, old.values))
    return fit


def _two_d_genome(population, what: str) -> torch.Tensor:
    genome = population.genome
    if not isinstance(genome, torch.Tensor) or genome.ndim != 2:
        raise ValueError(f"{what} needs a single 2-D tensor genome "
                         "(pop, dim)")
    return genome


def fused_var_or(key, population, toolbox, lambda_: int, cxpb, mutpb):
    """The megakernel form of :func:`deap_tpu_torch.algorithms.var_or`,
    behind ``ea_mu_plus_lambda``/``ea_mu_comma_lambda`` when the toolbox
    declares ``generation_engine = "megakernel"``.

    The key splits seven ways in ``var_or``'s order, and the choice of
    each row (crossover, mutation or copy) and its parent indices come
    from the same draws, so they equal the traced path's; the operator
    arithmetic is K3's own counter stream (:func:`megakernel_var_or`),
    seeded from ``k_cx`` and ``k_mut``."""
    assert cxpb + mutpb <= 1.0, (
        "The sum of the crossover and mutation probabilities must be smaller "
        "or equal to 1.0.")
    genome = _two_d_genome(population, "megakernel var_or")
    params = megakernel_variation_params(toolbox)
    storage = storage_of(toolbox) or GenomeStorage()
    if genome.dtype != storage.torch_dtype:
        raise ValueError(f"genome dtype {genome.dtype} != declared "
                         f"storage {storage.dtype}")
    n, dim = genome.shape

    ia, i2, code, seed = _var_or_draws(key, n, lambda_, cxpb, mutpb)
    knobs = _knobs((params["mut_mu"], params["mut_sigma"], params["indpb"]),
                   genome.device)
    child = megakernel_var_or(genome, ia, i2, code, seed, knobs, dim=dim,
                              storage=storage)
    old = population.fitness
    return Population(child, Fitness.empty(lambda_, old.weights,
                                           old.values.dtype, genome.device))


def _var_or_law(key, n: int, lambda_: int, cxpb, mutpb):
    """``var_or``'s key law, shared by both engines: the seven-way split,
    the choice masks (crossover where ``u < cxpb``, mutation where
    ``cxpb <= u < cxpb + mutpb``, bounds rounded to float32), the parent
    indices ``i1``, ``i2`` (a distinct partner), ``im``, ``ir`` and the
    operator keys.  Returns ``(use_cx, use_mut, i1, i2, im, ir, k_cx,
    k_mut)``."""
    k_choice, k_p1, k_p2, k_cx, k_pm, k_mut, k_pr = random.split(key, 7)
    u = random.uniform(k_choice, (lambda_,))
    cx = float(np.float32(cxpb))
    use_cx = u < cx
    use_mut = (u >= cx) & (u < float(np.float32(cxpb + mutpb)))
    i1 = random.randint(k_p1, (lambda_,), 0, n)
    off = random.randint(k_p2, (lambda_,), 1, n)
    i2 = (i1 + off) % n
    im = random.randint(k_pm, (lambda_,), 0, n)
    ir = random.randint(k_pr, (lambda_,), 0, n)
    return use_cx, use_mut, i1, i2, im, ir, k_cx, k_mut


def _var_or_draws(key, n: int, lambda_: int, cxpb, mutpb):
    """K3's inputs under :func:`_var_or_law`: each row's parent ``ia``,
    partner ``i2``, choice ``code`` (0 crossover, 1 mutation, 2 copy) and
    the seed folded from ``k_cx`` and ``k_mut``."""
    use_cx, use_mut, i1, i2, im, ir, k_cx, k_mut = _var_or_law(
        key, n, lambda_, cxpb, mutpb)
    code = torch.where(use_cx, 0, torch.where(use_mut, 1, 2)).to(torch.int32)
    ia = torch.where(use_cx, i1, torch.where(use_mut, im, ir))
    return ia, i2, code, _seed_from_key(k_cx) ^ _seed_from_key(k_mut)


def fused_nsga2_step(key, population, toolbox, cxpb, mutpb, *, live=None):
    """The megakernel form of an NSGA-II generation: ``ea_ask`` routes
    here when ``generation_engine = "megakernel"`` and ``select`` is
    ``sel_nsga2``.  The registered selection picks ``pop`` parents (its
    dominance counts through K4 on the card), and K1 varies them with
    the GA flagship's pairing, knobs and draw stream.  Every produced
    row comes back invalid; the key splits three ways as in
    :func:`fused_ea_step`, and ``live`` keeps the serving contract."""
    genome = _two_d_genome(population, "megakernel generation")
    params = megakernel_variation_params(toolbox)
    storage = storage_of(toolbox) or GenomeStorage()
    pop, dim = genome.shape

    key, k_sel, k_var = random.split(key, 3)
    idx = toolbox.select(k_sel, population.fitness, pop)
    if live is not None:
        live_n = torch.clamp(live.to(idx.dtype).sum(), min=1)
        idx = torch.where(idx < live_n, idx, idx % live_n)
    seed = _seed_from_key(k_var)
    knobs = _knobs((cxpb, mutpb, params["mut_mu"], params["mut_sigma"],
                    params["indpb"]), genome.device)
    varied = megakernel_vary(genome[idx.long()], seed, knobs, dim=dim,
                             storage=storage)
    if live is not None:
        rows = torch.arange(pop, device=genome.device)[:, None]
        varied = torch.where(rows < live_n, varied, genome)
    return key, Population(varied, _fresh_fitness(population, live))
