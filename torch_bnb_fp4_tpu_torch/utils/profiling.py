"""Timing and roofline helpers for the H100.

Counterpart of ``torch_bnb_fp4_tpu/utils/profiling.py``: ``time_fn`` times
on the card with CUDA events (PyTorch returns before the device finishes, so
a host clock would time the enqueue), ``trace`` records a ``torch.profiler``
trace, ``span`` names a stretch of host code in such a trace, ``calibrate_rtt`` measures a host-device round trip, ``detect_chip``
names the card, and the rooflines use the H100 SXM's published dense peaks.
A card set below its 700 W limit runs slower than these peaks; report its
``power.limit`` beside any share of them.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time

import torch

from .device import resolve_device

# NVIDIA H100 SXM data sheet, dense rates
H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where a card is
    present) around a block and write it to ``log_dir``/trace.json (default:
    ``tbfp4_trace`` in the temporary directory); open it in Perfetto.
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.path.join(tempfile.gettempdir(), "tbfp4_trace") if log_dir is None else log_dir
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A context naming a stretch of host code in the ``torch.profiler``
    trace being recorded (a ``record_function`` range, on the clock of the
    trace's CUDA kernels); with no profiler recording, one shared no-op
    context, so a span off costs one flag check."""
    return torch.profiler.record_function(name) if _profiling() else _OFF


def calibrate_rtt(device=None) -> float:
    """Median seconds of a host -> device -> host round trip: a one-element
    add on ``device`` (default: the card) and the fetch of its result."""
    dev = resolve_device(device)
    x = torch.zeros(1, device=dev)
    (x + 1.0).item()
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        (x + 1.0).item()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def detect_chip(default: str = "H100") -> str:
    """The card's name (``torch.cuda.get_device_name(0)``), or ``default``
    where there is no card."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else default


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
    k and v each read or written once, at their own element sizes (an e4m3
    K/V cache moves one byte per element); 4 * D * Hq bf16 tensor-core
    operations (the QK and PV products) per visible pair
    (:func:`visible_pairs`)."""
    d, hq = q.shape[3], q.shape[2]
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
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


def fp4_matmul_roofline(m: int, k: int, n: int, chip: str = "H100", achieved_s: float | None = None,
                        int8: bool = False) -> dict:
    """Roofline of a fused FP4 matmul on the H100 (the JAX package's
    function and keys; ``chip`` accepts "H100" alone): bytes = packed K*N/2
    + f32 scales (K/64)*N*4 + bf16 x M*K*2 + bf16 out M*N*2, operations
    2*M*K*N at the bf16 tensor-core peak, or the int8 one with ``int8`` (the
    w4a8 path's ceiling).  ``t_mxu_us`` keeps the JAX key for the
    tensor-core time.  With ``achieved_s``, also the fraction of the
    roofline reached."""
    if chip != "H100":
        raise ValueError(f"fp4_matmul_roofline knows the H100's peaks only, got chip={chip!r}")
    bytes_moved = k * n / 2 + (k // 64) * n * 4 + m * k * 2 + m * n * 2
    t_mem = bytes_moved / H100_HBM_BYTES_PER_S
    t_mma = 2 * m * k * n / (H100_INT8_OPS if int8 else H100_BF16_FLOPS)
    out = dict(bound="memory" if t_mem > t_mma else "compute", t_mem_us=t_mem * 1e6, t_mxu_us=t_mma * 1e6,
               roofline_us=max(t_mem, t_mma) * 1e6)
    if achieved_s is not None:
        out["fraction_of_roofline"] = max(t_mem, t_mma) / achieved_s
    return out
