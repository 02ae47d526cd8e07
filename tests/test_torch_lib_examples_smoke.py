"""The port's ten library examples at ``tests/test_examples.py``'s
arguments (their defaults; the multiswarm 20 generations) against that
table's ``SMOKE`` checks, on the CPU.  Their parity with the JAX
examples is ``tests/test_torch_lib_examples.py``'s."""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# name -> (port main kwargs, check) as tests/test_examples.py's SMOKE
SMOKE = {
    "ga.onemax_multidemic": (dict(), lambda r: float(
        r.fitness.values.max()) >= 85),
    "pso.basic": (dict(), lambda r: r < 1.0),
    "pso.multiswarm": (dict(ngen=20), None),
    "de.basic": (dict(), lambda r: r < 1e-1),
    "de.sphere": (dict(), None),
    "de.dynamic": (dict(), None),
    "eda.emna": (dict(), lambda r: r < 1e-2),
    "eda.pbil": (dict(), lambda r: r >= 45),
    "coev.coop_evol": (dict(), lambda r: r >= 85),
    "coev.hillis": (dict(), lambda r: r <= 20),
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_example_smoke_check(name):
    """Each example at ``tests/test_examples.py``'s arguments (its
    defaults; multiswarm 20 generations) on the port, against that
    table's check."""
    tm = importlib.import_module(f"deap_tpu_torch.examples.{name}")
    kw, check = SMOKE[name]
    result = tm.main(verbose=False, device="cpu", **kw)
    if check is not None:
        assert check(result)
    elif name == "de.sphere":
        assert all(np.isfinite(v) for v in result.values())
    else:
        assert len(result) > 0 and np.isfinite(result).all()
