"""The port's seventeen examples of this slice at
``tests/test_examples.py``'s arguments (their defaults where that table
gives none) against that table's ``SMOKE`` checks, on the CPU.  Their
parity with the JAX examples is ``tests/test_torch_es_examples.py``'s,
``tests/test_torch_ga_examples_rest.py``'s and
``tests/test_torch_coev_pso_examples.py``'s.

None is marked ``slow``, not even the seven that ``tests/test_examples.py``
lists in ``SLOW_SMOKE``: together they take about 30 s here, and on the
card (``chip_smoke.py`` phase 49, launch-bound) their checks' depths would
take minutes.  cma_bipop alone is ~30 s of this file."""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _fit_max(pop):
    return float(pop.fitness.values.max())


# name -> (port main kwargs, check) as tests/test_examples.py's SMOKE
SMOKE = {
    "ga.onemax": (dict(), lambda r: _fit_max(r[0]) >= 95),
    "ga.onemax_short": (dict(), lambda r: _fit_max(r) >= 95),
    "ga.mo_rhv": (dict(ngen=100), lambda r: r[1] > 116.0),
    "ga.knapsack": (dict(), lambda r: bool(
        (r.fitness.values[:, 0] <= 50).all())),
    "ga.xkcd": (dict(ngen=20), None),
    "ga.evosn": (dict(pop_size=200, ngen=20), lambda r: r[1][0] <= 6),
    "es.cma_minfct": (dict(), lambda r: r < 1e-8),
    "es.cma_one_plus_lambda": (dict(), lambda r: r < 30.0),
    "es.cma_bipop": (dict(), lambda r: r < 2.0),
    "es.cma_mo": (dict(ngen=120), lambda r: r > 116.0),
    "es.cma_plotting": (dict(ngen=85), lambda r: r < 10.0),
    "es.onefifth": (dict(), lambda r: r < 1e-4),
    "pso.speciation": (dict(), lambda r: r >= 1),
    "coev.coop_gen": (dict(ngen=100), lambda r: r[1] >= 45),
    "coev.coop_niche": (dict(ngen=120), lambda r: min(r[1]) >= 0.9),
    "coev.coop_adapt": (dict(ngen=200), lambda r: r[1] >= 42),
    "coev.symbreg": (dict(ngen=30), lambda r: r < 1.0),
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_example_smoke_check(name, tmp_path):
    tm = importlib.import_module(f"deap_tpu_torch.examples.{name}")
    kw, check = SMOKE[name]
    if name == "es.cma_plotting":
        kw = dict(kw, out_png=str(tmp_path / "cma_plotting.png"))
    result = tm.main(verbose=False, device="cpu", **kw)
    if check is not None:
        assert check(result), result
    else:
        assert np.isfinite(result.fitness.values.numpy()).all()
