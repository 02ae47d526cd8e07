"""Joining a cluster — the port's counterpart of
``deap_tpu/parallel/multihost.py``, on ``torch.distributed``.

Every process runs the same script (SPMD) and joins one process group;
a :func:`cluster_mesh` then spans every rank.  Launch (one process per
rank)::

    DEAP_TPU_COORDINATOR=host0:1234 DEAP_TPU_NPROC=4 DEAP_TPU_PROC_ID=$i \\
        python train.py

    # in train.py
    from deap_tpu_torch.parallel import initialize_cluster, cluster_mesh
    initialize_cluster()                       # reads the env
    mesh = cluster_mesh(("pop",))
    pop = distribute_population(pop, mesh)     # this rank's rows
    ...ea_simple(key, pop, tb, ...)...

The backend is an argument: ``"nccl"`` by default when a card is
present (one card a rank), ``"gloo"`` on the CPU — and on purpose for
two ranks on one card, which NCCL refuses ("Duplicate GPU detected").
Nothing switches backend after a failure.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import warnings

import torch
import torch.distributed as dist

from ..base import Fitness, Population, _map
from . import collectives
from .mapper import (DEFAULT_TIMEOUT_S, Mesh, ShardedPopulation, _pad_rows,
                     check_axis, default_mesh, population_sharding)

__all__ = ["initialize_cluster", "cluster_mesh", "distribute_population",
           "fetch_global", "process_index", "process_count"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(coordinator_address, num_processes, process_id):
    """The JAX function's priority rules: explicit arguments, then
    ``DEAP_TPU_COORDINATOR`` / ``DEAP_TPU_NPROC`` / ``DEAP_TPU_PROC_ID``;
    the legacy ``JAX_COORDINATOR`` / ``NPROC`` / ``PROC_ID`` only as a
    set, when ``JAX_COORDINATOR`` itself is set (a stray ``NPROC``
    exported for ``make -j$NPROC`` must not leak into a launch)."""
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("DEAP_TPU_COORDINATOR")
                           or env.get("JAX_COORDINATOR"))
    if num_processes is None and "DEAP_TPU_NPROC" in env:
        num_processes = int(env["DEAP_TPU_NPROC"])
    if process_id is None and "DEAP_TPU_PROC_ID" in env:
        process_id = int(env["DEAP_TPU_PROC_ID"])
    if "JAX_COORDINATOR" in env:
        if num_processes is None and "NPROC" in env:
            num_processes = int(env["NPROC"])
        if process_id is None and "PROC_ID" in env:
            process_id = int(env["PROC_ID"])
    return coordinator_address, num_processes, process_id


def initialize_cluster(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       local_device_ids=None,
                       connect_attempts: int | None = None,
                       connect_backoff: float = 1.0, *,
                       backend: str | None = None,
                       init_method: str | None = None,
                       timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``torch.distributed.init_process_group``.

    Priority: explicit arguments, then the ``DEAP_TPU_*`` variables, then
    the legacy set (see :func:`_resolve`).  A coordinator
    ``host:port`` becomes ``tcp://host:port``; ``init_method`` (for
    example ``file://...``) takes its place when given.  Without a
    coordinator and with at most one process, the call joins a group of
    one on a free local port (the JAX function's single-process
    fallback), warning when nothing asked for it.  A call that names a
    coordinator or a process count of more than one never falls back.

    ``backend`` defaults to ``"nccl"`` with a card and ``"gloo"``
    without.  ``timeout`` (seconds) bounds every collective of the
    group.  ``connect_attempts`` (default ``DEAP_TPU_CONNECT_ATTEMPTS``,
    else 1) retries a failed connection with ``connect_backoff`` seconds
    of backoff, doubling; a ``ValueError`` (configuration) is never
    retried.  A rank drives one device, picked by :func:`cluster_mesh`
    (``device=``), so ``local_device_ids`` is refused.  A call while the
    process group exists does nothing."""
    if local_device_ids is not None:
        raise ValueError("local_device_ids: a rank of the port drives one "
                         "device; pass device= to cluster_mesh")
    if dist.is_initialized():
        return
    coordinator_address, num_processes, process_id = _resolve(
        coordinator_address, num_processes, process_id)
    explicit = (coordinator_address is not None or process_id is not None
                or init_method is not None)
    if connect_attempts is None:
        connect_attempts = int(os.environ.get("DEAP_TPU_CONNECT_ATTEMPTS",
                                              "1"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None:
        if num_processes not in (None, 1):
            raise ValueError(
                f"initialize_cluster: {num_processes} processes need a "
                "coordinator (DEAP_TPU_COORDINATOR=host:port) or an "
                "init_method")
        if not explicit and num_processes is None:
            warnings.warn("single-process fallback: no coordinator given "
                          "(DEAP_TPU_COORDINATOR unset)")
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        num_processes, process_id = 1, 0
    if num_processes is None or process_id is None:
        raise ValueError(
            "initialize_cluster: a coordinator needs the process count and "
            "this process's id (DEAP_TPU_NPROC, DEAP_TPU_PROC_ID)")

    delay = connect_backoff
    for attempt in range(max(1, connect_attempts)):
        try:
            dist.init_process_group(
                backend=backend, init_method=init_method,
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=timeout))
            break
        except ValueError:
            raise
        except (RuntimeError, OSError, ConnectionError):
            if attempt + 1 >= max(1, connect_attempts):
                raise
            time.sleep(delay)
            delay *= 2


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def cluster_mesh(axis_names=("pop",), shape=None, device=None, *,
                 timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh over every rank of the cluster.  The port's meshes are
    1-D (one process group, one axis); a second axis name is refused."""
    if len(axis_names) != 1:
        raise ValueError("the port's meshes are 1-D: pass one axis name")
    if shape is not None and tuple(shape) not in ((process_count(),),
                                                  (-1,)):
        raise ValueError(f"shape {shape} != ({process_count()},)")
    return default_mesh(axis_names[0], device=device, timeout=timeout)


def distribute_population(population: Population, mesh: Mesh,
                          axis_name: str | None = None
                          ) -> ShardedPopulation:
    """This process's own rows as its block of one global population of
    ``rows * process_count`` rows (each process seeds its own rows, as
    each SCOOP worker owned its sub-population).  Every rank must hold
    the same number of rows."""
    check_axis(mesh, axis_name)
    n_r = population.size
    sizes = collectives.all_gather(
        torch.tensor([n_r], dtype=torch.int64, device=mesh.device), mesh)
    if bool((sizes != n_r).any()):
        raise ValueError(f"ranks hold different row counts: "
                         f"{sizes.tolist()}")
    f = population.fitness
    return ShardedPopulation(
        _map(lambda x: x.to(mesh.device), population.genome),
        Fitness(f.values.to(mesh.device), f.valid.to(mesh.device),
                f.weights), mesh, n_r * mesh.size, 1)


def _gather_rows(x: torch.Tensor, mesh: Mesh, sh) -> torch.Tensor:
    """The global rows of a row-sharded leaf: blocks padded to ``n_loc``,
    gathered, trimmed to ``n``."""
    return collectives.all_gather(_pad_rows(x, sh.n_loc, 0).contiguous(),
                                  mesh)[:sh.n]


def fetch_global(tree, mesh: Mesh | None = None):
    """A sharded population (or tensor of this rank's rows, with
    ``mesh``) gathered into the global one, equal on every rank — for
    logging and checkpointing.  Without a mesh, and for anything that is
    not sharded, the value comes back as it is."""
    if isinstance(tree, ShardedPopulation):
        sh = tree.sharding
        f = tree.fitness
        return Population(
            _map(lambda x: _gather_rows(x, tree.mesh, sh), tree.genome),
            Fitness(_gather_rows(f.values, tree.mesh, sh),
                    _gather_rows(f.valid, tree.mesh, sh), f.weights))
    if mesh is not None and isinstance(tree, torch.Tensor):
        n = int(collectives.gather_sum(
            torch.tensor(tree.shape[0], device=mesh.device), mesh))
        return _gather_rows(tree, mesh, population_sharding(mesh, n))
    return tree
