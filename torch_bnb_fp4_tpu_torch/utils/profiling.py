"""Timing and roofline helpers for the H100.

Counterpart of ``torch_bnb_fp4_tpu/utils/profiling.py``: ``time_fn`` times
on the card with CUDA events (PyTorch returns before the device finishes, so
a host clock would time the enqueue), and the roofline uses the H100 SXM's
published dense peaks.  A card set below its 700 W limit runs slower than
these peaks; report its ``power.limit`` beside any share of them.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores


def time_fn(fn, *args, rep: int = 50, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` on the current CUDA device: warm up,
    then ``rep`` back-to-back calls between two CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures on the card; CUDA is not available")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(rep):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / rep


def time_graph(fn, *args, rep: int = 50) -> float:
    """Device seconds per call of ``fn(*args)``: ``rep`` calls captured in one
    CUDA graph and replayed between two CUDA events, so the host's launch cost
    (Python wrappers, eager dispatch) is not in the figure.  Use
    :func:`time_fn` for what an eager caller sees."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_graph measures on the card; CUDA is not available")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rep):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / rep


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM rate
    and ops over the peak rate for their type.  Returns (seconds, bound_by)."""
    t_mem = bytes_moved / H100_HBM_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def visible_pairs(q_positions, kv_valid, kv_positions, sliding_window=None, chunk: int = 1024) -> int:
    """(query, key) pairs the causal / validity / window mask admits, summed
    over the batch: the work an attention call's data needs."""
    total = 0
    kpos, kval = kv_positions[:, None, :], kv_valid[:, None, :]
    for q0 in range(0, q_positions.shape[1], chunk):
        qpos = q_positions[:, q0 : q0 + chunk, None]
        mask = (kpos <= qpos) & kval
        if sliding_window is not None:
            mask = mask & (kpos > qpos - sliding_window)
        total += int(mask.sum())
    return total


def attention_bound_s(q, k, pairs: int) -> tuple[float, str]:
    """Bound of one attention call, q (B, Lq, Hq, D), k (B, Lk, Hk, D): q, o,
    k and v each read or written once; 4 * D * Hq bf16 tensor-core operations
    (the QK and PV products) per visible pair (:func:`visible_pairs`)."""
    d, hq = q.shape[3], q.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound_s(nbytes, 4 * d * hq * pairs, H100_BF16_FLOPS)


def pk_matmul_bound_s(m: int, k: int, n: int, *, x_bytes: int, out_bytes: int, a8: bool,
                      scale_bytes: int = 4) -> tuple[float, str]:
    """Bound of one pair-K matmul (K2/K3/K4, and their K8 forms, which read
    ONE expert of the stack: the same bytes): the packed weight (K*N/2) and
    its scales ((K/64)*N), the activations (``x_bytes``, int8 plus row scales
    for K4) read once, the output written once; 2*M*K*N operations at the
    int8 tensor-core rate for K4 (``a8``), else the bf16 rate."""
    nbytes = k * n // 2 + (k // 64) * n * scale_bytes + x_bytes + m * n * out_bytes
    return bound_s(nbytes, 2 * m * k * n, H100_INT8_OPS if a8 else H100_BF16_FLOPS)


def matmul_w8_bound_s(m: int, k: int, n: int, block_k: int, out_bytes: int, bias: bool = False) -> tuple[float, str]:
    """Bound of one K5 call: the shadow w8 (K*N bytes) and its scales g
    ((K/block_k)*N f32), x8 (M*K) and rs (M*(K/block_k) f32) and the bias
    read once, the output written once; 2*M*K*N int8 tensor-core ops."""
    nk = k // block_k
    nbytes = k * n + nk * n * 4 + m * k + m * nk * 4 + (n * 4 if bias else 0) + m * n * out_bytes
    return bound_s(nbytes, 2 * m * k * n, H100_INT8_OPS)


def dequant_pk_bound_s(k: int, n: int, scale_bytes: int, out_bytes: int) -> tuple[float, str]:
    """Bound of one K6 call: the packed bytes (K*N/2) and scales
    ((K/64)*N*scale_bytes) read once, Wt (K*N*out_bytes) written once; one
    f32 multiply per weight on the CUDA cores."""
    return bound_s(k * n // 2 + (k // 64) * n * scale_bytes + k * n * out_bytes, k * n, H100_F32_FLOPS)


def splitk_matmul_bound_s(m: int, k: int, n: int, *, x_bytes: int, out_bytes: int, bias: bool = False) -> tuple[float, str]:
    """Bound of one K9b call: the packed weight (K*N/2) and its f32 absmax
    halves ((K/64)*N*4 = K*N/16) read once, x (``x_bytes`` per element) and
    the bias read once, the output written once; 2*M*K*N operations at the
    bf16 tensor-core rate for 16-bit x, at the 67 TFLOP/s CUDA-core rate for
    f32 x (a true f32 dot)."""
    nbytes = k * n // 2 + (k // 64) * n * 4 + m * k * x_bytes + (n * 4 if bias else 0) + m * n * out_bytes
    return bound_s(nbytes, 2 * m * k * n, H100_F32_FLOPS if x_bytes == 4 else H100_BF16_FLOPS)


def dequant_splitk_bound_s(k: int, n: int, out_bytes: int) -> tuple[float, str]:
    """Bound of one K9a call: the packed bytes (K*N/2) and f32 absmax
    (K*N/16) read once, Wt (K*N*out_bytes) written once; one f32 multiply per
    weight on the CUDA cores."""
    return bound_s(k * n // 2 + (k // 64) * n * 4 + k * n * out_bytes, k * n, H100_F32_FLOPS)
