"""k2_roofline.<cells>: K2 (``csrc/matmul_pk.cu``; its K8 expert form is the
same kernel) in the traced slice: the least time of its calls at their
shapes, over its device time, in %."""

from perfbench.readers import kernel_roofline


def read(rec, spec):
    return kernel_roofline(rec, spec, "K2")
