"""CPU tests of the benchmark (python -m pytest h100bench/tests)."""
