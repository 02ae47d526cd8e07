"""Device resolution for the port's entry points.

Entry points that create tensors take ``device=`` and default to
``"cuda"``.  With no card present they raise instead of moving to the
CPU: a run that silently lands on the host measures the wrong machine.
Inside the package a kernel is picked from the tensor's own device
(``x.is_cuda``), never from a process-wide default.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "NoCudaDevice"]


class NoCudaDevice(RuntimeError):
    """The caller asked for (or defaulted to) CUDA and no card is present."""


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises :class:`NoCudaDevice` for a CUDA device when
    ``torch.cuda.is_available()`` is false — pass ``device="cpu"`` to run
    on the host on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; deap_tpu_torch entry points "
            "default to device='cuda' — pass device='cpu' to run on the "
            "host explicitly")
    return dev
