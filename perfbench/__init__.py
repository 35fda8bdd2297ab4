"""The benchmark of the PyTorch/CUDA port on one H100: ``run.py`` runs one
cell of ``BENCHMARK.json`` once."""
