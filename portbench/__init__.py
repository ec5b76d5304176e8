"""The benchmark of the PyTorch/CUDA port (``run.py``; cells, metrics
and limits in ``BENCHMARK.json`` at the repository root)."""
