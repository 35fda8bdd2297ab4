"""step_mfu.<cells>: the model step's share, in %, of the chip's peak: the
least time of the work that the window's ticks needed (per forward pass, the
larger of its operations at 989 TFLOP/s bf16 or 1979 TOP/s int8 and its
bytes at 3.35 TB/s; ``perfbench/work.py``) over their host-clock time.
Time with no request in flight is left out; so is the traced slice."""

from perfbench.readers import tick_least_s, window_ticks


def read(rec, spec):
    ts = [t for t in window_ticks(rec) if t.prefill_tokens > 0 or t.decode_seqs]
    wall = sum(t.t1 - t.t0 for t in ts)
    return 100.0 * sum(tick_least_s(spec.geometry, t) for t in ts) / wall if wall > 0 else None
