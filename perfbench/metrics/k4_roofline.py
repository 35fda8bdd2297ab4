"""k4_roofline.<cells>: K4 (``csrc/matmul_pk_w4a8.cu``, int8 activations)
in the traced slice: the least time of its calls at their shapes (int8
operations at 1979 TOP/s against bytes at 3.35 TB/s), over its device time
with its K-split combine, in %."""

from perfbench.readers import kernel_roofline


def read(rec, spec):
    return kernel_roofline(rec, spec, "K4")
