"""CPU tests of the benchmark, and tests marked ``cuda`` for the card."""
