"""ES examples of the port."""
