"""Co-evolution examples of the port."""
