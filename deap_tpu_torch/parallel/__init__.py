"""Parallelism and distribution — the port's counterpart of
``deap_tpu/parallel/``, on ``torch.distributed``.

The JAX package is single-controller: one process calls each function
on a global array a mesh shards, and XLA inserts the collectives.  The
port is SPMD: one process per rank, each with its own ``torch.device``
(``cuda:{local_rank}``, or the CPU when asked), an explicit process
group per mesh (:class:`~.mapper.Mesh`), and every rank calling the same
function at the same time on its own block of rows.  An input the JAX
package gives as ``P(axis, ...)`` is the rank's contiguous block of rows
(:func:`~.mapper.population_sharding`); a ``P()`` input is the same
value on every rank; outputs follow the same rule, so a replicated
result (a hypervolume, a selection's indices) comes back equal on every
rank.  ``lax.all_gather(tiled=True)``, ``lax.psum``, ``ppermute`` and
``lax.axis_index`` become :mod:`.collectives`' rank-order gather,
gather-then-sum, ring exchange and the mesh's rank.  Keys are passed
in, never drawn from a global generator, and the trajectory does not
depend on the rank count.

NCCL runs one card a rank; gloo runs the CPU, and two ranks on one card
(NCCL refuses those), staging CUDA tensors through host memory.

``shard_map_compat`` of the JAX package is a shim over jax versions'
``shard_map``; it has no meaning here (every function of this package
is already per rank) and is not ported.
"""

from .mapper import (Mesh, RowSharding, ShardedPopulation, tpu_map,
                     default_mesh, shard_population, population_sharding,
                     pad_to_multiple)  # noqa: F401
from .multihost import (initialize_cluster, cluster_mesh,
                        distribute_population, fetch_global,
                        process_index, process_count)  # noqa: F401
from .islands import (ea_simple_islands, stack_populations,
                      unstack_populations)  # noqa: F401
from .emo_sharded import (nondominated_ranks_sharded, sel_nsga2_sharded,
                          dominance_counts_sharded)  # noqa: F401
