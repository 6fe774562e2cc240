"""CPU tests of the benchmark (run: python -m pytest bench/tests)."""
