"""deap_tpu_torch — the PyTorch/CUDA port of ``deap_tpu``.

The JAX package stays the reference; this package runs the same
evolutionary algorithms on an NVIDIA card with PyTorch tensors, and the
fused GA generation of the JAX package's Pallas megakernel as
hand-written CUDA kernels (``deap_tpu_torch/kernels``).  It imports
neither JAX nor anything of ``deap_tpu``.

Module names follow the JAX package (``base``, ``random``,
``algorithms``, ``engines``, ``benchmarks``, ``ops.selection``,
``ops.crossover``, ``ops.mutation``, ``ops.generation`` for
``ops/generation_pallas.py``, ``utils.support``), so each counterpart
is easy to find.  Entry points that create tensors take ``device=`` and
default to ``"cuda"``; without a card they raise rather than run on the
CPU (:mod:`deap_tpu_torch._device`).
"""

from ._device import NoCudaDevice, resolve_device
from .base import Fitness, Population, Toolbox

__all__ = ["Toolbox", "Fitness", "Population", "NoCudaDevice",
           "resolve_device"]
