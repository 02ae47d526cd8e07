"""GP examples of the port."""
