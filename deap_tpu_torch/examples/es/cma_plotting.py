"""CMA-ES internals plotting — the port's counterpart of
``examples/es/cma_plotting.py``: rastrigin at N = 10, lambda = 200, 125
generations, tracing sigma, the covariance axis ratio, the squared
scaling axes ``diagD**2``, the best fitness and vector, and the
per-coordinate standard deviations, then the reference's four-panel
figure, written with matplotlib's Agg backend to the path the caller
gives.  The traces stay on the device until the run ends."""

from __future__ import annotations

import numpy as np
import torch

from ... import base, benchmarks, cma, random
from ...algorithms import evaluate_population

N = 10
NGEN = 125
LAMBDA = 20 * N


def setup(device=None):
    """``(strategy, toolbox)`` of the example."""
    strategy = cma.Strategy(centroid=[5.0] * N, sigma=5.0, lambda_=LAMBDA,
                            device=device)
    tb = base.Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    return strategy, tb


def gen_step(strategy, tb, carry, k):
    """One generation: ``(state, fbest, xbest)`` in and out, and the
    generation's trace."""
    state, fbest, xbest = carry
    genome = strategy.generate(state, k)
    pop = base.Population(genome, base.Fitness.empty(
        LAMBDA, (-1.0,), device=genome.device))
    pop, _ = evaluate_population(tb, pop)
    state = strategy.update(state, pop)
    fits = pop.fitness.values[:, 0]
    i = torch.argmin(fits)
    better = fits[i] < fbest
    fbest = torch.where(better, fits[i], fbest)
    xbest = torch.where(better, genome[i], xbest)
    trace = dict(
        sigma=state.sigma,
        axis_ratio=(state.diagD.max() / state.diagD.min()) ** 2,
        diagD2=state.diagD ** 2,
        fbest=fbest,
        best=xbest,
        std=torch.std(genome, dim=0, correction=0),
        favg=fits.mean(), fmin=fits.min(), fmax=fits.max())
    return (state, fbest, xbest), trace


def run(seed=64, ngen=NGEN, device=None):
    """``(final carry, traces)``: each trace stacked over the
    generations, as host arrays."""
    strategy, tb = setup(device)
    dev = strategy.device
    carry = (strategy.init(), torch.tensor(float("inf"), device=dev),
             torch.zeros(N, device=dev))
    traces = []
    for k in random.split(random.PRNGKey(seed, device=dev), ngen):
        carry, tr = gen_step(strategy, tb, carry, k)
        traces.append(tr)
    return carry, {name: torch.stack([t[name] for t in traces]).cpu().numpy()
                   for name in traces[0]}


def plot(tr, ngen: int, out_png: str) -> None:
    """The reference's four panels, to ``out_png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(0, LAMBDA * ngen, LAMBDA)
    plt.figure(figsize=(10, 8))
    plt.subplot(2, 2, 1)
    plt.semilogy(x, tr["favg"], "--b")
    plt.semilogy(x, tr["fmax"], "--b")
    plt.semilogy(x, tr["fmin"], "-b")
    plt.semilogy(x, tr["fbest"], "-c")
    plt.semilogy(x, tr["sigma"], "-g")
    plt.semilogy(x, tr["axis_ratio"], "-r")
    plt.grid(True)
    plt.title("blue: f-values, green: sigma, red: axis ratio")

    plt.subplot(2, 2, 2)
    plt.plot(x, tr["best"])
    plt.grid(True)
    plt.title("Object Variables")

    plt.subplot(2, 2, 3)
    plt.semilogy(x, tr["diagD2"])
    plt.grid(True)
    plt.title("Scaling (All Main Axes)")

    plt.subplot(2, 2, 4)
    plt.semilogy(x, tr["std"])
    plt.grid(True)
    plt.title("Standard Deviations in All Coordinates")

    plt.tight_layout()
    plt.savefig(out_png, dpi=90)
    plt.close()


def main(seed=64, ngen=NGEN, out_png="cma_plotting.png", verbose=True,
         device=None):
    """Runs, writes the figure to ``out_png`` and returns the best
    rastrigin value found."""
    (_, fbest, _), tr = run(seed, ngen, device)
    plot(tr, ngen, out_png)
    if verbose:
        print(f"final best rastrigin: {float(fbest):.4e}; wrote {out_png}")
    return float(fbest)


if __name__ == "__main__":
    main()
