"""Start ``R`` rank processes on one host and collect what each returns.

``run_ranks("pkg.module:function", R, backend=..., device=...,
kwargs=...)`` starts ``R`` interpreters running ``python -m
deap_tpu_torch.parallel.launch SPEC``.  Each joins one process group
through a ``file://`` rendezvous in ``workdir`` (no fixed port, so
concurrent launches never collide), builds the default mesh on
``device`` and calls ``function(mesh=mesh, **kwargs)``; what it
returns is saved with ``torch.save`` and handed back in rank order.
From the shell::

    python -m deap_tpu_torch.parallel.launch --ranks 2 --device cpu \\
        deap_tpu_torch.examples.ga.onemax_sharded:main

Every wait is bounded: the process group has ``timeout`` seconds for
each collective, and the launcher kills every rank once one fails or
the whole run outlasts ``deadline`` seconds, then raises
:class:`RankFailure` with the failed rank's output.  The rank processes
import only this package (and what ``function``'s module imports).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["run_ranks", "RankFailure", "main"]


class RankFailure(RuntimeError):
    """A rank process failed, or the ranks outlasted their deadline."""


def _target(spec: str):
    import importlib
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


def run_ranks(target: str, nranks: int, *, backend: str = "gloo",
              device: str = "cpu", kwargs: dict | None = None,
              timeout: float = 60.0, deadline: float = 300.0,
              workdir: str | os.PathLike | None = None,
              env: dict | None = None, threads: int | None = None) -> list:
    """Run ``target(mesh=mesh, **kwargs)`` on ``nranks`` ranks; return the
    ranks' results in rank order (module docstring).  ``threads`` caps
    each rank's CPU threads (``torch.set_num_threads``)."""
    own_dir = workdir is None
    wd = Path(tempfile.mkdtemp(prefix="deap_tpu_torch_ranks_")
              if own_dir else workdir)
    wd.mkdir(parents=True, exist_ok=True)
    spec = wd / "spec.pt"
    torch.save({"target": target, "nranks": int(nranks), "backend": backend,
                "device": device, "kwargs": kwargs or {},
                "timeout": float(timeout), "threads": threads,
                "init_method": f"file://{wd / 'rendezvous'}"}, spec)
    root = str(Path(__file__).resolve().parents[2])
    base_env = dict(os.environ if env is None else env)
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, base_env.get("PYTHONPATH", "")) if p)
    procs, logs = [], []
    try:
        for r in range(nranks):
            log = open(wd / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deap_tpu_torch.parallel.launch",
                 str(spec), str(r)],
                env=dict(base_env, LOCAL_RANK=str(r)), cwd=root,
                stdout=log, stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RankFailure(_report(wd, bad[0], f"exit {codes[bad[0]]}"))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                raise RankFailure(_report(
                    wd, codes.index(None),
                    f"still running after {deadline} s"))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
        for log in logs:
            log.close()
    out = [torch.load(wd / f"result{r}.pt", weights_only=False)
           for r in range(nranks)]
    if own_dir:
        import shutil
        shutil.rmtree(wd, ignore_errors=True)
    return out


def _report(wd: Path, rank: int, why: str) -> str:
    text = ""
    for r in sorted(wd.glob("rank*.log")):
        tail = r.read_text(errors="replace")[-4000:]
        text += f"\n--- {r.name} ---\n{tail}"
    return f"rank {rank}: {why}{text}"


def _cli(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m deap_tpu_torch.parallel."
                                 "launch")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--deadline", type=float, default=600.0)
    ap.add_argument("target", help="module:function, called with mesh=")
    args = ap.parse_args(argv)
    run_ranks(args.target, args.ranks, backend=args.backend,
              device=args.device, deadline=args.deadline)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0].startswith("--"):
        return _cli(argv)
    spec_path, rank = Path(argv[0]), int(argv[1])
    spec = torch.load(spec_path, weights_only=False)
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    from .multihost import initialize_cluster
    from .mapper import default_mesh
    initialize_cluster(init_method=spec["init_method"],
                       num_processes=spec["nranks"], process_id=rank,
                       backend=spec["backend"], timeout=spec["timeout"])
    mesh = default_mesh(device=spec["device"], timeout=spec["timeout"])
    result = _target(spec["target"])(mesh=mesh, **spec["kwargs"])
    tmp = spec_path.with_name(f"result{rank}.pt.tmp")
    torch.save(result, tmp)
    tmp.replace(spec_path.with_name(f"result{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
