"""PSO examples of the port."""
