"""BIPOP-CMA-ES restarts — the port's counterpart of
``examples/es/cma_bipop.py`` (reference ``examples/es/cma_bipop.py``,
Hansen 2009): large-population restarts (lambda doubled each time)
alternate with small-population runs on a budget, and the best
solution is kept across restarts.

Each inner CMA-ES run goes ``CHUNK`` generations at a time; between
chunks the host reads the chunk's best values and the stopping
statistics (TolHistFun over a window, TolX, the condition number of
``diagD``), as the JAX example reads them between its jitted chunks.
:func:`regime_stops` is that decision and :func:`schedule` the restart
law (lambda, sigma, generation budget), so each can be held alone."""

from __future__ import annotations

import math

import numpy as np
import torch

from ... import base, benchmarks, cma, random
from ...algorithms import evaluate_population

N = 10
NRESTARTS = 6
SIGMA0 = 2.0
CHUNK = 50                    # generations between host checks
TOLHISTFUN = 1e-12
TOLX = 1e-12
CONDITIONCOV = 1e14


def chunk(strategy, tb, key, state, length: int = None):
    """``length`` (default ``CHUNK``) generations from ``(key, state)``:
    ``(key, state, best value of each generation)``."""
    bests = []
    for _ in range(CHUNK if length is None else length):
        key, k_gen = random.split(key)
        genome = strategy.generate(state, k_gen)
        pop = base.Population(genome, base.Fitness.empty(
            strategy.lambda_, (-1.0,), device=genome.device))
        pop, _ = evaluate_population(tb, pop)
        state = strategy.update(state, pop)
        bests.append(pop.fitness.values.min())
    return key, state, torch.stack(bests)


def stop_statistics(state):
    """``(tolx, cond)`` of a state (reference cma_bipop.py:150-190):
    every ``pc`` entry and every ``sqrt(C_ii)`` below ``TOLX``, and the
    squared ratio of the largest to the smallest ``diagD``."""
    tolx = bool((state.pc < TOLX).all()
                & (torch.sqrt(torch.diagonal(state.C)) < TOLX).all())
    cond = (state.diagD[-1] / torch.clamp(state.diagD[0], min=1e-30)) ** 2
    return tolx, float(cond)


def regime_stops(hist, lambda_: int, tolx: bool, cond: float) -> bool:
    """Whether a run stops after a chunk, given every generation's best
    so far: a flat window of TolHistFun, TolX, or a condition number
    past ``CONDITIONCOV``."""
    window = 10 + int(math.ceil(30.0 * N / lambda_))
    if len(hist) >= window and (max(hist[-window:]) - min(hist[-window:])
                                < TOLHISTFUN):
        return True
    return tolx or cond > CONDITIONCOV


def run_regime(key, centroid, sigma, lambda_, max_iter, evaluate,
               device=None):
    """One CMA-ES run in chunks: ``(best value, its centroid, evals)``."""
    strategy = cma.Strategy(centroid=centroid, sigma=sigma,
                            lambda_=lambda_, device=device)
    state = strategy.init()
    tb = base.Toolbox()
    tb.register("evaluate", evaluate)
    evals = 0
    best_overall = np.inf
    best_x = None
    hist = []
    t = 0
    while t < max_iter:
        key, state, bests = chunk(strategy, tb, key, state)
        bests = bests.cpu().numpy()
        evals += CHUNK * lambda_
        t += CHUNK
        i = int(np.argmin(bests))
        if bests[i] < best_overall:
            best_overall = float(bests[i])
            best_x = state.centroid.cpu().numpy()
        hist.extend(bests.tolist())
        if regime_stops(hist, lambda_, *stop_statistics(state)):
            break
    return best_overall, best_x, evals


def schedule(i, n_small, small_budget, large_budget, rng, lambda0):
    """Restart ``i``'s regime: ``(large, lambda_, sigma, max_iter)``;
    draws from ``rng`` for a small one (reference cma_bipop.py)."""
    large = not (0 < i < NRESTARTS + n_small - 1
                 and sum(small_budget) < sum(large_budget))
    if large:
        lambda_ = 2 ** (i - n_small) * lambda0
        sigma = SIGMA0
        max_iter = int(100 + 50 * (N + 3) ** 2 / math.sqrt(lambda_))
    else:
        lambda_ = max(2, int(lambda0 * (0.5 * (2 ** (i - n_small)))
                             ** (rng.rand() ** 2)))
        sigma = 2 * 10 ** (-2 * rng.rand())
        max_iter = max(CHUNK, int(0.5 * (large_budget[-1] if large_budget
                                         else 1000) / lambda_))
    return large, lambda_, sigma, max_iter


def main(seed=12, verbose=True, device=None):
    """The JAX example's run from ``PRNGKey(seed)`` and
    ``RandomState(seed)``.  Returns the best value over the restarts."""
    evaluate = benchmarks.rastrigin
    rng = np.random.RandomState(seed)
    lambda0 = 4 + int(3 * math.log(N))
    best = np.inf
    small_budget, large_budget = [], []
    n_small = 0
    key = random.PRNGKey(seed, device=device)
    i = 0
    while i < NRESTARTS + n_small:
        key, k_run = random.split(key)
        large, lambda_, sigma, max_iter = schedule(
            i, n_small, small_budget, large_budget, rng, lambda0)
        if not large:
            n_small += 1
        budget = large_budget if large else small_budget
        centroid = rng.uniform(-4, 4, N)
        run_best, _, run_evals = run_regime(
            k_run, centroid, sigma, lambda_, max_iter, evaluate,
            device=key.device)
        budget.append(run_evals)
        best = min(best, run_best)
        if verbose:
            print(f"restart {i}: regime={'large' if large else 'small'}"
                  f" λ={lambda_} evals={run_evals} best={run_best:.4e}")
        if best < 1e-10:
            break
        i += 1
    if verbose:
        print(f"overall best: {best:.4e}")
    return best


if __name__ == "__main__":
    main()
