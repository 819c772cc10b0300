"""Cost models of the port."""
