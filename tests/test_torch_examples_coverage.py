"""Every runnable example of the JAX package (``examples/**/*.py`` but
``__init__.py``) has its port at the same path under
``deap_tpu_torch/examples/``, as ``tests/test_examples.py``'s
``test_every_example_covered`` holds the JAX examples to their smoke
table.  Since the port's distribution slice none is missing: the three
that waited on it (``ga/onemax_island.py``, ``ga/onemax_sharded.py``,
``ga/onemax_multihost.py``) have their ports.  File names only: nothing
of the JAX package is imported."""

import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
# examples still waiting on a part of the port: none
AWAITING_DISTRIBUTION = set()


def _examples(root):
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
            if p.name != "__init__.py"}


def test_every_example_has_a_port():
    jax_examples = _examples(REPO / "examples")
    ported = _examples(REPO / "deap_tpu_torch" / "examples")
    assert AWAITING_DISTRIBUTION <= jax_examples
    missing = jax_examples - ported - AWAITING_DISTRIBUTION
    assert not missing, f"examples without a port: {sorted(missing)}"
    assert not ported - jax_examples, "port examples with no JAX example"
    assert not AWAITING_DISTRIBUTION & ported, "update AWAITING_DISTRIBUTION"
