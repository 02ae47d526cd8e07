"""GA examples of the port."""
