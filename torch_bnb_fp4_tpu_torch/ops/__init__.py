"""Pair-K format, CUDA kernels and their build (the JAX package's names)."""

from . import format, kernels
from .format import FP4_CODE, NF4_CODE, dequantize_fp4, quantize_fp4
from .kernels import dequantize_fp4_flat, dequantize_tpu, gemv_fp4, matmul_fp4

__all__ = [
    "format",
    "kernels",
    "FP4_CODE",
    "NF4_CODE",
    "quantize_fp4",
    "dequantize_fp4",
    "dequantize_tpu",
    "matmul_fp4",
    "gemv_fp4",
    "dequantize_fp4_flat",
]
