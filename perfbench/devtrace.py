"""A ``torch.profiler`` slice of the window, reduced to what the per-layer
metrics read: the device operations by kernel, the busy time (the union of
their intervals), the slice's length, and the idle gaps by what the host was
doing meanwhile.  The trace is written to a temporary file, read and
deleted."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MIN_GAP_US = 20.0  # shorter gaps are launch spacing, not idle time worth naming
TICK = "perfbench.tick"  # the annotation around each Engine.step


def group(name: str) -> str:
    """The kernel group a device operation belongs to (the grouping of the
    port's ``benchmarks_torch/decode_profile.py``)."""
    low = name.lower()
    if "splitk" in name:
        return "K9b split-K"
    if "matmul_pk_wgmma" in name or "matmul_pk_kernel" in name or "reduce_splits" in name:
        return "K2 (and its K8 form)"
    if "minner" in name:
        return "K3 (and its K8 form)"
    if "w4a8" in name or "combine_terms" in name:
        return "K4 (and its K8 form)"
    if "w8_kernel" in name:
        return "K5"
    if "flash_kernel" in name or "flash_combine" in name:
        return "K7 flash attention"
    if "gemm" in low or "gemv" in low or "cutlass" in low or "sm90" in low or "cublas" in low:
        return "cuBLAS GEMM (dense attention, lm_head, router)"
    if "softmax" in low:
        return "softmax"
    if "index" in low or "scatter" in low or "gather" in low:
        return "indexing (KV writes, embedding)"
    if "reduce" in low or "norm" in low:
        return "reductions (norms, top-k)"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    if "copy" in low or "cast" in low or "elementwise" in low:
        return "elementwise / copies / casts"
    return "other"


# the device operations of one call of a kernel: its main kernel first, then
# its helpers (a K split's reduction or combine pass)
KERNEL_OPS = {"K2": ("matmul_pk_wgmma_kernel", "matmul_pk_kernel", "reduce_splits_kernel"),
              "K4": ("w4a8_kernel", "combine_terms")}
MAIN_OPS = {"K2": ("matmul_pk_wgmma_kernel", "matmul_pk_kernel"), "K4": ("w4a8_kernel",)}


def of_kernel(kernel: str, main: bool = False):
    """Predicate on a device operation's name: part of a call of ``kernel``
    (``main``: its main kernel only, one per call)."""
    names = (MAIN_OPS if main else KERNEL_OPS)[kernel]
    return lambda n: any(k in n for k in names)


class Slice:
    """The reduced trace: ``ops`` (name, start us, duration us) of the
    device, ``host`` (name, start us, duration us) of the host, and the
    slice's bounds."""

    def __init__(self, events: list[dict]):
        self.ops = sorted((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                          if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
        host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]
        # the thread that drives the engine: the one of the harness's tick annotations
        ticks = [e.get("tid") for e in host if e["name"] == TICK]
        tid = max(set(ticks), key=ticks.count) if ticks else None
        self.host = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in host
                            if tid is None or e.get("tid") == tid), key=lambda h: h[1])
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                 if e.get("ph") == "X" and "ts" in e]
        self.t0 = min(s for s, _ in spans) if spans else 0.0
        self.t1 = max(t for _, t in spans) if spans else 0.0

    @classmethod
    def from_profiler(cls, prof) -> "Slice":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, ts, dur in sorted(self.ops, key=lambda o: o[1]):
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ts + dur)
            else:
                merged.append([ts, ts + dur])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def time_s(self, pred) -> float:
        """Device seconds of the operations whose name satisfies ``pred``."""
        return sum(d for n, _, d in self.ops if pred(n)) / 1e6

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.ops if pred(n))

    def device_ops(self, top: int = 10) -> list[list]:
        by = defaultdict(float)
        for n, _, d in self.ops:
            by[group(n)] += d / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle gaps of the device, summed by the innermost host event of the
        engine's thread under each gap's midpoint (``python (no traced op)``
        where there is none)."""
        starts = [h[1] for h in self.host]
        by = defaultdict(float)
        edges = [self.t0] + [x for iv in self.busy_intervals() for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b - a < MIN_GAP_US:
                continue
            mid = (a + b) / 2
            name = "python (no traced op)"
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                h = self.host[j]  # events of one thread nest: the latest-starting one that covers is innermost
                if h[1] + h[2] >= mid:
                    name = h[0]
                    break
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
