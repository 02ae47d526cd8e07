"""Carry state between the JAX package and the port, as numpy arrays.

Neither package imports the other; the tests hand numpy arrays across:
raw keys of either implementation, ``uint32[..., 2]`` (threefry2x32) or
``uint32[..., 4]`` (rbg; the data of a typed key is
``jax.random.key_data(key)``), a genome in any storage dtype (bfloat16 as
its ``uint16`` bit pattern, or as an ``ml_dtypes.bfloat16`` array, which
is what ``np.asarray`` of a JAX bfloat16 array gives), a tuple of such
arrays (a GP genome: codes, consts, lengths) or a dict of them (a
neuroevolution genome), fitness
``values``/``valid``/``weights``, a genome storage declaration given
by its ``dtype`` and ``bound`` fields, and the state of a CMA strategy
or an archive and the states of PSO and the EDAs, read field by field
from any object that has the JAX package's field names (``CMAState``,
``OnePlusLambdaState``, ``_ArchiveState``, ``PSOState``,
``MultiswarmState``, ``EMNAState``, ``PBILState``), and the memory of ``SelNSGA3WithMemory`` (its
``best_point`` and ``extreme_points``, host arrays in both packages),
and the host snapshot of a served session (``EvolutionService.
snapshot_sessions()`` / ``drain()`` of either package: numpy arrays, the
key as raw ``uint32`` words, Python scalars).

Like every entry point that creates tensors, the ``*_to_torch``
functions default to ``device="cuda"`` and raise
:class:`~deap_tpu_torch.NoCudaDevice` without a card; pass
``device="cpu"`` to build the state on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .base import Fitness, Population
from .cma import CMAState, OnePlusLambdaState
from .eda import EMNAState, PBILState
from .ops.generation import GenomeStorage
from .pso import MultiswarmState, PSOState
from .utils.support import _ArchiveState

__all__ = ["key_to_torch", "key_to_numpy", "genome_to_torch",
           "genome_to_numpy", "population_to_torch", "population_to_numpy",
           "storage_to_torch", "cma_state_to_torch",
           "one_plus_lambda_state_to_torch", "archive_state_to_torch",
           "nsga3_memory_to_torch", "pso_state_to_torch",
           "multiswarm_state_to_torch", "emna_state_to_torch",
           "pbil_state_to_torch", "session_snapshot_to_torch",
           "session_snapshot_to_numpy"]


def key_to_torch(key, device=None) -> torch.Tensor:
    """Raw key words ``uint32[..., 2]`` or ``uint32[..., 4]`` (a raw key,
    a batch of them, or ``jax.random.key_data`` of a typed key) → the
    port's keys of the same shape."""
    dtype = getattr(key, "dtype", None)
    if dtype is not None and str(dtype).startswith("key<"):
        raise TypeError("a typed jax key: pass jax.random.key_data(key)")
    words = np.asarray(key)
    if words.ndim == 0 or words.shape[-1] not in (2, 4):
        raise ValueError(f"key words of shape {words.shape}: the last "
                         "dimension is 2 (threefry2x32) or 4 (rbg)")
    words = words.astype(np.uint32).astype(np.int64)
    return torch.tensor(words, device=resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's keys → ``uint32`` words of the same shape (wrap rbg
    words with ``jax.random.wrap_key_data(words, impl="rbg")``)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def genome_to_torch(genome, device=None):
    """A genome array → a tensor; a tuple of arrays (a GP genome ``(codes
    int32 (pop, cap), consts float32 (pop, cap), lengths int32 (pop,))``)
    → a tuple of tensors; a dict of arrays → a dict of tensors."""
    device = resolve_device(device)
    if isinstance(genome, dict):
        return {k: genome_to_torch(v, device) for k, v in genome.items()}
    if isinstance(genome, (tuple, list)):
        return tuple(genome_to_torch(g, device) for g in genome)
    g = np.asarray(genome)
    if g.dtype.name == "bfloat16":
        g = g.view(np.uint16)
    if g.dtype == np.uint16:            # bfloat16 bit pattern
        return torch.from_numpy(g.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(g, copy=True)).to(device)


def genome_to_numpy(genome):
    """The port's genome → numpy (a tuple genome → a tuple of arrays, a
    dict → a dict); bfloat16 comes back as its ``uint16`` bit pattern
    (numpy has no bfloat16)."""
    if isinstance(genome, dict):
        return {k: genome_to_numpy(v) for k, v in genome.items()}
    if isinstance(genome, (tuple, list)):
        return tuple(genome_to_numpy(g) for g in genome)
    g = genome.detach().cpu()
    if g.dtype == torch.bfloat16:
        return g.view(torch.int16).numpy().view(np.uint16)
    return g.numpy()


def population_to_torch(genome, values, valid, weights,
                        device=None) -> Population:
    device = resolve_device(device)
    fit = Fitness(values=torch.tensor(np.asarray(values, np.float32),
                                      device=device),
                  valid=torch.tensor(np.asarray(valid, bool), device=device),
                  weights=tuple(float(w) for w in weights))
    return Population(genome_to_torch(genome, device), fit)


def population_to_numpy(population: Population):
    """``(genome, values, valid, weights)`` as numpy arrays and a tuple."""
    fit = population.fitness
    return (genome_to_numpy(population.genome),
            fit.values.detach().cpu().numpy(),
            fit.valid.detach().cpu().numpy(), fit.weights)


def storage_to_torch(storage) -> GenomeStorage:
    """Any object with ``dtype`` and ``bound`` (the JAX package's
    ``GenomeStorage``) → the port's :class:`GenomeStorage`."""
    return GenomeStorage(str(storage.dtype), float(storage.bound))


def _fields_to_torch(cls, state, device):
    device = resolve_device(device)
    return cls(**{f.name: torch.from_numpy(
        np.array(getattr(state, f.name), copy=True)).to(device)
        for f in dataclasses.fields(cls)})


def cma_state_to_torch(state, device=None) -> CMAState:
    """The JAX package's ``CMAState`` (any object with its fields) → the
    port's :class:`~deap_tpu_torch.cma.CMAState`."""
    return _fields_to_torch(CMAState, state, device)


def one_plus_lambda_state_to_torch(state, device=None) -> OnePlusLambdaState:
    """The JAX package's ``OnePlusLambdaState`` → the port's."""
    return _fields_to_torch(OnePlusLambdaState, state, device)


def archive_state_to_torch(state, device=None) -> _ArchiveState:
    """The JAX package's archive state (``genome``, ``values``,
    ``filled``, ``weights``) → the port's."""
    device = resolve_device(device)
    return _ArchiveState(
        genome=genome_to_torch(state.genome, device),
        values=torch.tensor(np.asarray(state.values), device=device),
        filled=torch.tensor(np.asarray(state.filled, bool), device=device),
        weights=tuple(float(w) for w in state.weights))


def nsga3_memory_to_torch(ideal, extreme):
    """The JAX package's ``SelNSGA3WithMemory`` state (``best_point``
    ``(nobj,)``, ``extreme_points`` ``(nobj, nobj)`` or ``None``) → the
    port's ``(best_point, extreme_points)``: float32 host arrays, which
    the port's :class:`~deap_tpu_torch.ops.emo.SelNSGA3WithMemory` keeps
    as they are (``sel.best_point, sel.extreme_points = ...``)."""
    ideal = np.array(ideal, dtype=np.float32)
    if ideal.ndim != 1:
        raise ValueError(f"best_point of shape {ideal.shape}: expected "
                         "(nobj,)")
    if extreme is None:
        return ideal, None
    extreme = np.array(extreme, dtype=np.float32)
    if extreme.shape != (ideal.shape[0],) * 2:
        raise ValueError(f"extreme_points of shape {extreme.shape}: "
                         f"expected {(ideal.shape[0],) * 2}")
    return ideal, extreme


def pso_state_to_torch(state, device=None) -> PSOState:
    """The JAX package's ``PSOState`` → the port's."""
    return _fields_to_torch(PSOState, state, device)


def multiswarm_state_to_torch(state, device=None) -> MultiswarmState:
    """The JAX package's ``MultiswarmState`` → the port's."""
    return _fields_to_torch(MultiswarmState, state, device)


def emna_state_to_torch(state, device=None) -> EMNAState:
    """The JAX package's ``EMNAState`` → the port's."""
    return _fields_to_torch(EMNAState, state, device)


def pbil_state_to_torch(state, device=None) -> PBILState:
    """The JAX package's ``PBILState`` (its key as raw words, or a typed
    key's ``key_data``) → the port's."""
    device = resolve_device(device)
    return PBILState(
        prob_vector=torch.from_numpy(np.array(state.prob_vector, np.float32,
                                              copy=True)).to(device),
        key=key_to_torch(state.key, device))


_SNAPSHOT_ARRAYS = ("values", "valid")


def session_snapshot_to_torch(snap: dict, device=None) -> dict:
    """One session's snapshot (the JAX package's ``_snapshot_one`` dict:
    ``gen``, ``phase``, ``n``, ``priority``, ``weights``, ``rows``,
    ``key``, ``genome``, ``values``, ``valid``, ``cxpb``, ``mutpb`` and
    maybe ``pending``) → the same dict with its key, genome and fitness
    arrays as the port's tensors on ``device`` (the scalars as they
    are).  :meth:`~deap_tpu_torch.serve.EvolutionService.adopt_sessions`
    takes either form."""
    device = resolve_device(device)
    out = dict(snap)
    out["key"] = key_to_torch(snap["key"], device)
    out["genome"] = genome_to_torch(snap["genome"], device)
    out["values"] = torch.tensor(np.asarray(snap["values"], np.float32),
                                 device=device)
    out["valid"] = torch.tensor(np.asarray(snap["valid"], bool),
                                device=device)
    if snap.get("pending") is not None:
        pend = snap["pending"]
        out["pending"] = {
            "genome": genome_to_torch(pend["genome"], device),
            "values": torch.tensor(np.asarray(pend["values"], np.float32),
                                   device=device),
            "valid": torch.tensor(np.asarray(pend["valid"], bool),
                                  device=device)}
    out["weights"] = tuple(float(w) for w in snap["weights"])
    return out


def _leaf_to_numpy(x):
    if isinstance(x, torch.Tensor):
        return genome_to_numpy(x)
    return np.asarray(x)


def session_snapshot_to_numpy(snap: dict) -> dict:
    """A session snapshot (the port's ``snapshot_sessions()`` entry, or
    :func:`session_snapshot_to_torch`'s) → numpy arrays and Python
    scalars, the JAX package's host form (its ``adopt_sessions`` and
    ``/v1/admin/restore`` take it; a bfloat16 genome comes back as its
    ``uint16`` bit pattern: view it as ``ml_dtypes.bfloat16`` there).
    The key is its raw ``uint32`` words."""
    out = dict(snap)
    key = snap["key"]
    out["key"] = (key_to_numpy(key) if isinstance(key, torch.Tensor)
                  else np.asarray(key).astype(np.uint32))
    out["genome"] = _genome_to_numpy_any(snap["genome"])
    for k in _SNAPSHOT_ARRAYS:
        out[k] = _leaf_to_numpy(snap[k])
    if snap.get("pending") is not None:
        pend = snap["pending"]
        out["pending"] = {"genome": _genome_to_numpy_any(pend["genome"]),
                          **{k: _leaf_to_numpy(pend[k])
                             for k in _SNAPSHOT_ARRAYS}}
    out["cxpb"] = float(snap["cxpb"])
    out["mutpb"] = float(snap["mutpb"])
    return out


def _genome_to_numpy_any(genome):
    """:func:`genome_to_numpy` over a genome whose leaves may already be
    numpy arrays."""
    if isinstance(genome, dict):
        return {k: _genome_to_numpy_any(v) for k, v in genome.items()}
    if isinstance(genome, (tuple, list)):
        return tuple(_genome_to_numpy_any(g) for g in genome)
    return _leaf_to_numpy(genome)
