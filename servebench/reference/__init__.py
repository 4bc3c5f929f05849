"""reference of the port's benchmark, found by name."""
