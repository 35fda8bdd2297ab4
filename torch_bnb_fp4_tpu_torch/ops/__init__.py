"""Pair-K format, CUDA kernels and their build."""
