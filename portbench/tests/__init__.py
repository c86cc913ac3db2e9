"""CPU tests of the benchmark's harness (no card needed)."""
