"""The benchmark of the PyTorch and CUDA port (see bench/harness.py)."""
