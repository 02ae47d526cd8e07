"""Operators of the port: selection (``selection``, and ``emo`` for
NSGA-II), crossover, mutation, the dominance counts (``dominance``) and
the fused generation (``generation``), whose CUDA kernels live in
``deap_tpu_torch/kernels``."""
