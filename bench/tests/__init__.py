"""CPU tests of the benchmark (run: PYTHONPATH=src python -m pytest bench/tests)."""
