"""Checkpoint / resume — the port's counterpart of
``deap_tpu/utils/checkpoint.py``.

The reference documents checkpointing as a pattern: pickle the
population, generation, hall of fame, logbook and ``random.getstate()``
every few generations.  Here it is an API over any nest of dicts, lists,
tuples and dataclasses (a :class:`~deap_tpu_torch.base.Population`, a
strategy state, a PSO state): tensors are copied to host numpy,
everything else pickles as it is, and the PRNG **key** takes the place
of ``random.getstate()``.  A key is a tensor whose last dimension names
its implementation (2 words threefry2x32, 4 rbg), so it is stored with
its implementation and a resumed run draws what the undisturbed one
draws.

Files are written atomically (a ``.tmp`` file, then ``replace``).
:func:`load_checkpoint` puts every tensor back on the device asked for,
in its dtype (bfloat16 included).

The per-shard tier (:func:`save_sharded_checkpoint` /
:func:`load_sharded_checkpoint`) writes one fragment per rank of a mesh:
each rank the rows it holds of every sharded population
(:class:`~deap_tpu_torch.parallel.ShardedPopulation`), rank 0 the
replicated tensors and the other leaves.  Saves are versioned step
directories committed by one atomic marker swing, and a load can
restore onto another rank count.  The files are the port's own (host
arrays pickled, as in the unsharded tier); they are not the JAX
package's ``.npz`` fragments.
"""

from __future__ import annotations

import dataclasses
import pickle
import re
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint", "async_save_checkpoint",
           "save_sharded_checkpoint", "load_sharded_checkpoint"]


@dataclasses.dataclass(frozen=True)
class _HostTensor:
    """A tensor's values on the host: ``array`` (bfloat16 as its int16
    bits) and the torch dtype's name."""

    array: np.ndarray
    dtype: str


def _tensor_to_host(x: torch.Tensor) -> _HostTensor:
    # a blocking copy: the values are on the host when this returns, so a
    # writer thread started afterwards never reads a copy in flight
    on_host = x.device.type == "cpu"
    x = x.detach().to("cpu")
    name = str(x.dtype).removeprefix("torch.")
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    # a host tensor is copied too: the caller may change it after a save
    return _HostTensor(x.numpy().copy() if on_host else x.numpy(), name)


def _tensor_from_host(h: _HostTensor, device) -> torch.Tensor:
    t = torch.from_numpy(h.array)
    if h.dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _map_tree(fn, x):
    """``fn`` on every tensor (or stored tensor) of a nest of dicts,
    lists, tuples (named ones too) and dataclass instances; other leaves
    (a :class:`~deap_tpu_torch.utils.support.Logbook`, whose records are
    host values) stay as they are."""
    if isinstance(x, (torch.Tensor, _HostTensor)):
        return fn(x)
    if type(x) is dict:
        return {k: _map_tree(fn, v) for k, v in x.items()}
    if type(x) is list:
        return [_map_tree(fn, v) for v in x]
    if isinstance(x, tuple):
        vals = [_map_tree(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_tree(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _to_host(state):
    return _map_tree(_tensor_to_host, state)


def _write(path: Path, host_state) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(host_state, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def save_checkpoint(path, state: Any) -> None:
    """Atomically pickle a state (population, PRNG key, strategy state,
    logbook, ...) to ``path``, its tensors as host arrays."""
    _write(Path(path), _to_host(state))


class _AsyncSave(threading.Thread):
    """Writer thread that keeps its exception.  ``result()`` joins and
    re-raises it once (the orbax ``wait_until_finished`` contract)."""

    def __init__(self, write_fn):
        super().__init__(daemon=True, name="deap-tpu-torch-async-ckpt")
        self._write_fn = write_fn
        self.exc: BaseException | None = None

    def run(self):
        try:
            self._write_fn()
        except BaseException as e:          # noqa: BLE001 — must not vanish
            # keep the exception, drop its frames: they pin the host copy
            self.exc = e.with_traceback(None)
        finally:
            # a finished writer must not keep the host copy alive
            self._write_fn = None

    def result(self, timeout: float | None = None) -> None:
        self.join(timeout)
        if self.is_alive():
            raise TimeoutError(
                f"async checkpoint write still running after {timeout}s")
        if self.exc is not None:
            exc, self.exc = self.exc, None      # report once
            raise exc


_async_registry_lock = threading.Lock()
# per-path cells {"lock", "handle"}, one for each distinct path, never
# removed: that is what keeps the per-path locking free of races
_async_saves: dict[str, dict] = {}


def async_save_checkpoint(path, state: Any) -> _AsyncSave:
    """Copy the state to the host now (a blocking copy, complete when
    this returns) and pickle it in a background thread, so the loop does
    not wait on the disk.

    Saves to the same path are serialized: a new call first joins that
    path's previous writer.  A writer's failure re-raises from the
    handle's ``result()`` or, if nobody joined, from the next
    ``async_save_checkpoint`` to that path, before its write starts (the
    checkpoint on disk is then still the previous one).  Saves to other
    paths neither wait for nor fail because of each other."""
    host_state = _to_host(state)
    key = str(Path(path).expanduser().resolve())

    def write():
        _write(Path(path), host_state)

    with _async_registry_lock:
        cell = _async_saves.setdefault(
            key, {"lock": threading.Lock(), "handle": None})
    with cell["lock"]:
        prev, cell["handle"] = cell["handle"], None
        if prev is not None:
            prev.join()
            if prev.exc is not None:
                exc, prev.exc = prev.exc, None      # report once
                raise RuntimeError(
                    f"previous async_save_checkpoint to {key} failed; the "
                    "new save was not started") from exc
        t = _AsyncSave(write)
        cell["handle"] = t
        t.start()
    return t


def load_checkpoint(path, device=None) -> Any:
    """The state saved at ``path``, every tensor on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        host_state = pickle.load(f)
    return _map_tree(lambda h: _tensor_from_host(h, dev), host_state)


# ---------------------------------------------------------------------------
# sharded (per-rank, rank-count-agnostic) tier
# ---------------------------------------------------------------------------


def _sharded_type():
    from ..parallel.mapper import ShardedPopulation
    return ShardedPopulation


def _walk(x, path: str, out: list, shard=None) -> None:
    """Flatten a state into ``(path, leaf, sharding)``: tensors of a
    sharded population carry its :class:`~deap_tpu_torch.parallel.
    RowSharding`, every other tensor ``None``; non-tensor leaves come
    through as they are.  A sharded and a plain population give the same
    paths."""
    if isinstance(x, _sharded_type()):
        sh = x.sharding
        _walk(x.genome, path + ".genome", out, sh)
        _walk(x.fitness, path + ".fitness", out, sh)
        return
    if isinstance(x, torch.Tensor):
        out.append((path, x, shard))
    elif type(x) is dict:
        for k, v in x.items():
            _walk(v, f"{path}[{k!r}]", out, shard)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk(v, f"{path}[{i}]", out, shard)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            if f.init:
                _walk(getattr(x, f.name), f"{path}.{f.name}", out, shard)
    else:
        out.append((path, x, None))


def _rebuild(like, path: str, get, shard=None, device=None):
    """``like`` with every tensor replaced by ``get(path, sharding,
    device)`` and every other leaf by ``get(path, None, None)``."""
    S = _sharded_type()
    if isinstance(like, S):
        sh = like.sharding
        dev = like.mesh.device
        genome = _rebuild(like.genome, path + ".genome", get, sh, dev)
        fitness = _rebuild(like.fitness, path + ".fitness", get, sh, dev)
        return S(genome, fitness, like.mesh, like.n, like.quantum)
    if isinstance(like, torch.Tensor):
        return get(path, shard, device if device is not None
                   else like.device)
    if type(like) is dict:
        return {k: _rebuild(v, f"{path}[{k!r}]", get, shard, device)
                for k, v in like.items()}
    if type(like) is list:
        return [_rebuild(v, f"{path}[{i}]", get, shard, device)
                for i, v in enumerate(like)]
    if isinstance(like, tuple):
        vals = [_rebuild(v, f"{path}[{i}]", get, shard, device)
                for i, v in enumerate(like)]
        return type(like)(*vals) if hasattr(like, "_fields") else \
            type(like)(vals)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), f"{path}.{f.name}", get,
                             shard, device)
            for f in dataclasses.fields(like) if f.init})
    return get(path, None, None)


def _state_mesh(flat):
    for _, leaf, sh in flat:
        if sh is not None:
            return sh
    return None


def _barrier(mesh) -> None:
    if mesh is not None:
        from ..parallel import collectives
        collectives.barrier(mesh)


def _read_commit(d: Path):
    """Parse ``COMMIT`` → ``(version, nproc)``, ``(None, nproc)`` for the
    flat layout, or ``None`` if absent.  Raises on corrupt content — a
    half-written marker must refuse, not silently skip validation."""
    try:
        txt = (d / "COMMIT").read_text().strip()
    except FileNotFoundError:
        return None
    toks = txt.split()
    if len(toks) == 2 and toks[0].startswith("v") and toks[0][1:].isdigit() \
            and toks[1].isdigit():
        return int(toks[0][1:]), int(toks[1])
    if len(toks) == 1 and toks[0].isdigit():
        return None, int(toks[0])
    raise ValueError(
        f"{d}: corrupt COMMIT marker {txt!r} — refusing to load")


def _prune_versions(d: Path, keep: Path | None) -> None:
    """Remove every ``v<digits>`` checkpoint subdirectory but ``keep``
    (only directories named exactly so: a sibling that merely starts
    with 'v' is never touched)."""
    for sub in d.glob("v*"):
        if sub != keep and sub.is_dir() and re.fullmatch(r"v\d+", sub.name):
            shutil.rmtree(sub, ignore_errors=True)


def _next_version(d: Path) -> int:
    """One past the highest ``v<digits>`` subdirectory, committed or
    not, so a new save never writes into an older attempt's directory."""
    vers = [int(m.group(1)) for sub in d.glob("v*")
            if sub.is_dir() and (m := re.fullmatch(r"v(\d+)", sub.name))]
    return max(vers, default=-1) + 1


def _atomic_pickle(path: Path, obj) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def save_sharded_checkpoint(dirpath, state: Any, mesh=None) -> None:
    """Write ``state`` under ``dirpath``: one chunk file and one manifest
    fragment per rank.  Every rank of the mesh calls it together.

    Each rank stores its rows of every tensor of a sharded population,
    tagged with their global row range; rank 0 also stores every other
    tensor (whole) and the non-tensor leaves.  ``mesh`` defaults to the
    mesh of the first sharded population in ``state`` (none: one
    writer).

    Saves are versioned: fragments go into a fresh ``v{N}/`` (rank 0
    picks ``N``, one past any version directory, and tells the others),
    and only after a barrier does rank 0 atomically swing the ``COMMIT``
    marker — the active version and the writer count — onto it, then
    delete the older versions.  A crash before the swing leaves the
    previous checkpoint loadable; after it, the new one."""
    d = Path(dirpath)
    flat: list = []
    _walk(state, "", flat)
    if mesh is None:
        first = next((leaf for leaf in _flat_sharded(state)), None)
        mesh = None if first is None else first.mesh
    rank, nproc = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    if rank == 0:
        d.mkdir(parents=True, exist_ok=True)
    version = _next_version(d) if rank == 0 else 0
    if mesh is not None:
        from ..parallel import collectives
        version = collectives.broadcast_int(version, mesh)
    vd = d / f"v{version}"
    vd.mkdir(parents=True, exist_ok=True)
    chunks: dict = {}
    meta: dict = {"leaves": {}, "chunks": [], "other": {}}
    for path, leaf, sh in flat:
        if not isinstance(leaf, torch.Tensor):
            if rank == 0:
                meta["other"][path] = leaf
            continue
        shape = list(leaf.shape)
        if sh is not None:
            shape[0] = sh.n
            box = (sh.start, sh.stop)
        elif rank == 0:
            box = (0, shape[0]) if shape else None
        else:
            continue
        meta["leaves"][path] = {"shape": tuple(shape),
                                "dtype": str(leaf.dtype)}
        ck = f"c{len(chunks)}"
        chunks[ck] = _tensor_to_host(leaf)
        meta["chunks"].append({"leaf": path, "box": box, "key": ck})
    _atomic_pickle(vd / f"shards_p{rank}.pkl", chunks)
    _atomic_pickle(vd / f"manifest_p{rank}.pkl", meta)
    _barrier(mesh)
    if rank == 0:
        c_tmp = d / "COMMIT.tmp"
        c_tmp.write_text(f"v{version} {nproc}")
        c_tmp.replace(d / "COMMIT")
        _prune_versions(d, keep=vd)
        for stale in (*d.glob("shards_p*"), *d.glob("manifest_p*")):
            stale.unlink(missing_ok=True)
    # no rank may start the next save (and read COMMIT) before the swing
    _barrier(mesh)


def _flat_sharded(state):
    S = _sharded_type()
    found: list = []

    def visit(x):
        if isinstance(x, S):
            found.append(x)
        elif type(x) is dict:
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                if f.init:
                    visit(getattr(x, f.name))
    visit(state)
    return found


def load_sharded_checkpoint(dirpath, like: Any, device=None) -> Any:
    """Rebuild a checkpoint written by :func:`save_sharded_checkpoint`.

    ``like`` has the saved structure.  Where it holds a
    :class:`~deap_tpu_torch.parallel.ShardedPopulation`, this rank gets
    that population's rows under ``like``'s mesh and layout — another
    rank count than the writers' is just another overlap of row ranges;
    a plain population or tensor gets the whole rows.  Tensors land on
    the sharded population's mesh device, else on ``device`` (default:
    the ``like`` tensor's device); non-tensor leaves come from the
    manifest.  The values are bit for bit those saved.

    Refuses a directory without a ``COMMIT`` marker, with a corrupt
    marker, or whose fragment count disagrees with the recorded writer
    count."""
    d = Path(dirpath)
    commit = _read_commit(d)             # raises ValueError if corrupt
    if commit is None:
        raise FileNotFoundError(
            f"{d} has no COMMIT marker: incomplete or not a sharded "
            "checkpoint")
    version, nproc = commit
    frag_dir = d if version is None else d / f"v{version}"
    frags = sorted(frag_dir.glob("manifest_p*.pkl"))
    if len(frags) != nproc:
        raise ValueError(
            f"{frag_dir}: COMMIT records {nproc} writer process(es) but "
            f"{len(frags)} manifest fragment(s) present — mixed or "
            "partially-cleaned checkpoint")
    leaves: dict = {}
    index: dict = {}
    other: dict = {}
    files: dict = {}
    for frag in frags:
        with open(frag, "rb") as f:
            meta = pickle.load(f)
        leaves.update(meta["leaves"])
        other.update(meta.get("other", {}))
        data = frag.with_name(frag.name.replace("manifest_", "shards_"))
        for c in meta["chunks"]:
            index.setdefault(c["leaf"], []).append((data, c))

    def chunk(p: Path, key: str):
        if p not in files:
            with open(p, "rb") as f:
                files[p] = pickle.load(f)
        return files[p][key]

    def get(path, sh, dev):
        if dev is None:
            if path not in other:
                raise KeyError(f"leaf {path} not present in checkpoint {d}")
            return other[path]
        if path not in leaves:
            raise KeyError(f"leaf {path} not present in checkpoint {d}")
        shape = leaves[path]["shape"]
        first_file, first = index[path][0]
        if not shape:
            return _tensor_from_host(chunk(first_file, first["key"]), dev)
        lo, hi = (sh.start, sh.stop) if sh is not None else (0, shape[0])
        parts, filled = [], lo
        for p, c in sorted(index[path], key=lambda pc: pc[1]["box"][0]):
            clo, chi = c["box"]
            a, b = max(filled, clo), min(hi, chi)
            if a >= b:
                continue
            if a != filled:
                break
            t = _tensor_from_host(chunk(p, c["key"]), "cpu")
            parts.append(t[a - clo:b - clo])
            filled = b
        if filled != hi:
            raise ValueError(
                f"leaf {path}: rows [{lo}, {hi}) not covered by the saved "
                "chunks — checkpoint written by a partial process set?")
        if not parts:                   # a rank that holds no rows
            return _tensor_from_host(chunk(first_file, first["key"]),
                                     "cpu")[:0].to(dev)
        return torch.cat(parts, 0).to(dev)

    return _rebuild(like, "", get, device=resolve_device(device)
                    if device is not None else None)
