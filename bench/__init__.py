"""The benchmark of the PyTorch/CUDA port: ``python3 bench/run.py`` runs one cell of ``BENCHMARK.json``."""
