"""What the port's probe tools share: the timing harness and the card
line (the data-sheet peaks of their bounds are in
:mod:`deap_tpu_torch.kernels.peaks`).

The tools (:mod:`deap_tpu_torch.probes.ga`, :mod:`deap_tpu_torch.probes.gp`)
are the counterparts of ``tools/pallas_probe_ga.py`` and
``tools/pallas_probe_gp.py``: each stage of a generation, timed alone on
the card, through the port's hand-written probe kernels (P1–P5,
``deap_tpu_torch/kernels/probes.cu``) and through single PyTorch calls.

Timing (:meth:`ProbeRun.marginal`): a probe is a step ``state -> state``
whose input depends on the last step's output, as the JAX tool's scans do.
It runs k and 2k times to warm up, as the JAX tool does (the kernel
library is built and the allocator filled there), then k and 2k times
again, :data:`PAIRS` times over, each run ending in
``torch.cuda.synchronize()``; the host clock around the two runs of the
median pair (by ``t2k - tk``) gives the marginal ``(t2k - tk) / k`` and
the ``t2k / tk`` linearity witness (about 2 when the measurement is
sound).  The median keeps one stall of the shared host out of the
marginal.  The steps are launched from Python, so a
probe of a few microseconds measures the launches as much as the kernel;
``chip_smoke.py`` times each kernel alone with CUDA events beside it.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from .._device import resolve_device

__all__ = ["PAIRS", "card_line", "ProbeRun"]

PAIRS = 3              # (tk, t2k) pairs a probe; the median one is kept


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class ProbeRun:
    """One run of a probe tool: its device, shapes and the records and
    errors it collects."""

    def __init__(self, device=None, *, pop: int, dim: int, k_iters: int):
        self.device = resolve_device(device)
        self.pop, self.dim, self.k_iters = pop, dim, k_iters
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        self.device_line = (card_line() if self.device.type == "cuda"
                            else "cpu")
        self.records: list = []
        self.errors: list = []
        self.walls = None

    @property
    def route(self) -> str:
        """How a probe kernel runs here: ``"cuda"`` or ``"plain"``."""
        return "cuda" if self.device.type == "cuda" else "plain"

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, fn) -> float:
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0

    def _walls(self, run, k: int):
        run(k)                               # warm, as the JAX tool does
        run(2 * k)
        pairs = sorted(((self._clock(lambda: run(k)),
                         self._clock(lambda: run(2 * k)))
                        for _ in range(PAIRS)), key=lambda p: p[1] - p[0])
        t1, t2 = pairs[PAIRS // 2]
        self.walls = (t1, t2, k)
        return (t2 - t1) / k, t2 / t1

    def marginal(self, step, state, k: int | None = None):
        """``step`` chained k and 2k times from ``state``: ``(marginal
        seconds per step, t2k / tk)``."""
        k = k or self.k_iters

        def run(n):
            s = state
            for _ in range(n):
                s = step(s)

        return self._walls(run, k)

    def timed(self, fn, k: int):
        """``fn()`` called k and 2k times: ``(marginal seconds per call,
        t2k / tk)``."""

        def run(n):
            for _ in range(n):
                fn()

        return self._walls(run, k)

    def report(self, name: str, sec: float, ratio: float, route: str,
               **extra) -> dict:
        """Record and print one probe's result."""
        rec = {"probe": name, "ms": sec * 1e3, "linearity_t2k_over_tk": ratio,
               "device": self.device_line, "route": route, **extra}
        if self.walls is not None:
            rec["wall_tk_s"], rec["wall_t2k_s"], rec["k"] = self.walls
        self.records.append(rec)
        print(json.dumps(rec), flush=True)
        return rec

    def error(self, probe: str, exc: Exception) -> None:
        """Record a probe this backend cannot run (never a number)."""
        err = {"probe": probe,
               "error": f"{type(exc).__name__}: {str(exc)[:300]}"}
        self.errors.append(err)
        print(json.dumps(err), flush=True)
