"""Statistics and logbook of the port (``support``)."""
