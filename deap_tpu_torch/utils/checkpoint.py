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

The per-shard tier of the JAX package (``save_sharded_checkpoint`` /
``load_sharded_checkpoint``) needs a device mesh; it comes with
distribution and raises :class:`ShardedNotPorted` here.
"""

from __future__ import annotations

import dataclasses
import pickle
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint", "async_save_checkpoint",
           "save_sharded_checkpoint", "load_sharded_checkpoint",
           "ShardedNotPorted"]


class ShardedNotPorted(NotImplementedError):
    """The sharded checkpoint tier needs a device mesh; not ported yet."""


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


def save_sharded_checkpoint(dirpath, state: Any) -> None:
    """The JAX package's per-shard tier; not ported."""
    raise ShardedNotPorted(
        "save_sharded_checkpoint is not ported to deap_tpu_torch yet: it "
        "writes the shards of a device mesh and comes with distribution "
        "(ROADMAP queue 1 item 9); use save_checkpoint on one card")


def load_sharded_checkpoint(dirpath, like: Any) -> Any:
    """The JAX package's per-shard tier; not ported."""
    raise ShardedNotPorted(
        "load_sharded_checkpoint is not ported to deap_tpu_torch yet: it "
        "restores onto a device mesh and comes with distribution (ROADMAP "
        "queue 1 item 9); use load_checkpoint on one card")
