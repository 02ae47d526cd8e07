"""Counterparts of the repo's ``examples/``: each module keeps its own copy
of the example's constants and functions and imports neither jax nor the
JAX package."""
