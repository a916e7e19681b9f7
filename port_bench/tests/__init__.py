"""CPU tests of the port's benchmark harness."""
