"""deap_tpu_torch — the PyTorch/CUDA port of ``deap_tpu``.

The JAX package stays the reference; this package runs the same
evolutionary algorithms on an NVIDIA card with PyTorch tensors, and the
JAX package's Pallas kernels on their paths — the fused GA generation,
the fused ``var_or``, the dominance counts of the NSGA-II front peel and
the GP stack-machine interpreter — as hand-written CUDA kernels
(``deap_tpu_torch/kernels``).  It imports neither JAX nor anything of
``deap_tpu``.

Module names follow the JAX package (``base``, ``random``,
``algorithms``, ``engines``, ``benchmarks``, ``ops.selection``,
``ops.crossover``, ``ops.mutation``, ``ops.emo``, ``ops.dominance`` for
``ops/dominance_pallas.py``, ``ops.generation`` for
``ops/generation_pallas.py``, ``gp`` with ``gp.interp_cuda`` for
``gp/interp_pallas.py``, ``utils.support``, ``parallel``,
``ops.generation_sharded``), so each counterpart is easy to find.  Entry points that create tensors take ``device=`` and
default to ``"cuda"``; without a card they raise rather than run on the
CPU (:mod:`deap_tpu_torch._device`).
"""

from ._device import NoCudaDevice, resolve_device
from .base import Fitness, Population, Toolbox

__all__ = ["Toolbox", "Fitness", "Population", "NoCudaDevice",
           "resolve_device"]
