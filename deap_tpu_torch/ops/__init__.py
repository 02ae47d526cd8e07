"""Operators of the port: selection, crossover, mutation and the fused
generation (``generation``) whose CUDA kernels live in
``deap_tpu_torch/kernels``."""
