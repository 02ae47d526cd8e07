"""Rank-side cases of the port's resilience tests.

``tests/test_torch_resilience.py`` starts two gloo ranks with
:func:`deap_tpu_torch.parallel.launch.run_ranks`; each rank runs
:func:`sharded_resumable_case` and returns plain tensors, gathered over
the ranks.  This module imports only torch and the port.
"""

from __future__ import annotations

import torch

from deap_tpu_torch import base, random
from deap_tpu_torch.ops import crossover, mutation, selection
from deap_tpu_torch.parallel import fetch_global, shard_population
from deap_tpu_torch.resilience import (FaultInjector, FaultPlan, Preempted,
                                       run_resumable)

N, BITS, NGEN = 64, 24, 4
KW = dict(checkpoint_every=2, loop_kwargs=dict(cxpb=0.5, mutpb=0.2))


def onemax_toolbox():
    tb = base.Toolbox()
    tb.register("evaluate", lambda g: (torch.sum(g),))
    tb.register("mate", crossover.cx_two_point)
    tb.register("mutate", mutation.mut_flip_bit, indpb=0.05)
    tb.register("select", selection.sel_tournament, tournsize=3)
    return tb


def start():
    k_init, k_run = random.split(random.PRNGKey(9, device="cpu"))
    g = random.bernoulli(k_init, 0.5, (N, BITS)).to(torch.float32)
    return k_run, base.Population(g, base.Fitness.empty(N, (1.0,),
                                                        device="cpu"))


def _flat(pop, mesh=None):
    if mesh is None:
        return [pop.genome, pop.fitness.values, pop.fitness.valid]
    return [fetch_global(pop.genome, mesh),
            fetch_global(pop.fitness.values, mesh),
            fetch_global(pop.fitness.valid, mesh)]


def sharded_resumable_reference() -> list:
    """The one-device run (no sharding, the single-pickle tier)."""
    import tempfile
    key, pop = start()
    with tempfile.TemporaryDirectory() as d:
        out, _ = run_resumable(key, pop, onemax_toolbox(), NGEN,
                               ckpt_path=f"{d}/ck.pkl", **KW)
    return _flat(out)


def sharded_resumable_case(mesh, ckpt_dir: str) -> dict:
    """``run_resumable(sharded=True)`` on this rank's rows: undisturbed,
    then preempted at generation 2 and resumed from the per-rank tier."""
    key, pop = start()
    spop = shard_population(pop, mesh, quantum=2)
    tb = onemax_toolbox()
    out, _ = run_resumable(key, spop, tb, NGEN, ckpt_path=f"{ckpt_dir}/u",
                           sharded=True, **KW)
    res = {"undisturbed": _flat(out, mesh), "preempted_at": None}
    try:
        run_resumable(key, spop, tb, NGEN, ckpt_path=f"{ckpt_dir}/p",
                      sharded=True,
                      faults=FaultInjector(FaultPlan(preempt_at_gen=2)), **KW)
    except Preempted as e:
        res["preempted_at"] = e.gen
    got, _ = run_resumable(key, spop, tb, NGEN, ckpt_path=f"{ckpt_dir}/p",
                           sharded=True, **KW)
    res["resumed"] = _flat(got, mesh)
    return res
