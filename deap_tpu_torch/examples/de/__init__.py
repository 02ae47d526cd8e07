"""DE examples of the port."""
