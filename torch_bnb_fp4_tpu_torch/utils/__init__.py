"""Device selection, synthetic models, timing, tracing and the H100 roofline
(the JAX package's names)."""

from .profiling import calibrate_rtt, detect_chip, fp4_matmul_roofline, time_fn, trace

__all__ = ["trace", "time_fn", "calibrate_rtt", "detect_chip", "fp4_matmul_roofline"]
