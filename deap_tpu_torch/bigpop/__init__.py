"""Out-of-core evolution: host-streamed populations beyond the card.

The resident executors (``xla``, ``megakernel``, ``megakernel_sharded``)
need the whole genome matrix in device memory; this package removes that
ceiling.  A :class:`HostPopulation` keeps the genome chunked in host RAM
in the storage dtype (int8 streams at a quarter of float32's bytes) and a
:class:`StreamedEngine` runs each generation as a sliced prefetch /
compute / drain pipeline through pinned staging buffers and CUDA copy
streams, with selection on the device from the fitness table.  A
streamed generation equals a resident one at the same pop and key, bit
for bit (:mod:`deap_tpu_torch.bigpop.engine`).

Entry points: ``toolbox.generation_engine = "streamed"`` routes
:func:`deap_tpu_torch.algorithms.ea_ask` / :func:`~deap_tpu_torch.
algorithms.ea_step` through :func:`streamed_ea_ask` /
:func:`streamed_ea_step`, and :func:`~deap_tpu_torch.algorithms.
ea_simple` through :func:`streamed_ea_simple` (the host loop);
:func:`run_streamed_resumable` adds mid-generation (between-slice)
checkpoint and resume.
"""

from .host import HostPopulation, DEFAULT_CHUNK_ROWS
from .engine import (StreamedEngine, GenerationResult, streamed_params,
                     streamed_ea_ask, streamed_ea_step, streamed_ea_simple,
                     DEFAULT_SLICE_ROWS)
from .runner import run_streamed_resumable
from .slicedprng import (check_prng_compat, sliced_bits, sliced_uniform,
                         sliced_normal, sliced_bernoulli)

__all__ = [
    "HostPopulation", "DEFAULT_CHUNK_ROWS", "StreamedEngine",
    "GenerationResult", "streamed_params", "streamed_ea_ask",
    "streamed_ea_step", "streamed_ea_simple", "DEFAULT_SLICE_ROWS",
    "run_streamed_resumable", "check_prng_compat", "sliced_bits",
    "sliced_uniform", "sliced_normal", "sliced_bernoulli",
]
