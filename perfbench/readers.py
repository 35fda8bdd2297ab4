"""Arithmetic that the metric readers (``metrics/*.py``) share: tails over
all requests, rates over the window, tick classes, and the work of a tick
or of the kernel calls in the traced slice (``work.py``)."""

from __future__ import annotations

import math

from . import work
from .devtrace import of_kernel

LAUNCH_KEYS = {"K2": ("matmul_pk", "matmul_pk_expert"), "K3": ("matmul_pk_minner", "matmul_pk_minner_expert"),
               "K4": ("matmul_pk_w4a8", "matmul_pk_w4a8_expert")}


def percentile(values: list[float], q: float) -> float:
    """The ``q`` quantile, linear between order statistics (numpy's default)."""
    xs = sorted(values)
    h = (len(xs) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]):
        return xs[hi] if h > lo else xs[lo]
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def tail_ms(values: list[float], q: float = 0.95) -> float | None:
    """``q`` quantile in ms of seconds over all requests; a request that never
    finished counts as infinitely late, so a tail that reaches one is None."""
    if not values:
        return None
    v = percentile(values, q)
    return None if math.isinf(v) else v * 1e3


def ttft_s(rec) -> list[float]:
    """Time to first token of every request due in the window, from when it
    was due."""
    return [r.t_first - r.due if r.t_first is not None and r.done is not None else math.inf
            for r in rec.due_in_window]


def tpot_s(rec) -> list[float]:
    """(last token - first token) / (tokens - 1) of every request due in the
    window."""
    out = []
    for r in rec.due_in_window:
        if r.done is None or len(r.times) < 2:
            out.append(math.inf if r.done is None else 0.0)
        else:
            out.append((r.times[-1] - r.times[0]) / (len(r.times) - 1))
    return out


def window_ticks(rec) -> list:
    """Ticks wholly inside the window and outside the traced slice (the
    profiler slows the host)."""
    return [t for t in rec.ticks if t.t0 >= rec.open and t.t1 <= rec.close and not t.in_slice]


def decode_passes(t) -> list[list[tuple[int, int]]]:
    """A tick's decode passes: per step, (cached positions, 1) of each request
    that the step served."""
    return [[(c + j, 1) for c, d in t.decode_seqs if d > j] for j in range(t.decode_steps)]


def tick_least_s(g, t) -> float:
    """Least time of the work that a tick needed: its prefill passes and its
    decode passes, each at the larger of its operations at peak and its bytes
    at the HBM rate."""
    s = sum(work.pass_work(g, seqs, kernel_rows=m).least_s() for m, seqs in t.prefill)
    for seqs in decode_passes(t):
        if seqs:
            s += work.pass_work(g, seqs, kernel_rows=t.decode_m, logits_rows=len(seqs)).least_s()
    return s


def kernel_roofline(rec, spec, kernel: str) -> float | None:
    """Share, in %, of ``kernel``'s device time in the traced slice that the
    least time of the work it was given would take; each pass's shape from
    the harness's record of the slice's ticks (decode at the program's rows,
    prefills at their bucket or chunk).  The non-expert calls are counted as
    the kernel is given them, and held equal to the program's launch counts;
    the expert forms' work is what the served rows' routed tokens need
    (``work.expert_work``), whatever the dispatch, so only the sum of both
    forms' launches is held to the trace's count.  None when the slice holds
    no work of the kernel, or when the counts disagree."""
    if rec.slice is None or rec.slice_launches is None:
        return None
    g = spec.geometry
    calls, experts = [], 0.0  # experts: the least time of the expert forms' work, pass by pass
    for t in [t for t in rec.ticks if t.in_slice]:
        for m, seqs in t.prefill:
            calls += work.pass_calls(g, m)
            if work.kernel_of(m) == kernel:
                experts += work.expert_work(g, sum(r for _, r in seqs), kernel).least_s()
        for seqs in decode_passes(t):
            calls += work.pass_calls(g, t.decode_m)
            if work.kernel_of(t.decode_m) == kernel:
                experts += work.expert_work(g, len(seqs), kernel).least_s()
    mine = [c for c in calls if c[0] == kernel]
    dense_key, expert_key = LAUNCH_KEYS[kernel]
    launched = sum(rec.slice_launches.get(k, 0) for k in (dense_key, expert_key))
    traced = rec.slice.count(of_kernel(kernel, main=True))
    dev = rec.slice.time_s(of_kernel(kernel))
    if not (mine or experts) or len(mine) != rec.slice_launches.get(dense_key, 0) or traced != launched \
            or dev <= 0:
        return None
    least = sum(work.linear_call(m, k, n, out_bytes=ob, blocksize=g.blocksize, kernel=kernel).least_s()
                for _, m, k, n, ob in mine) + experts
    return 100.0 * least / dev
