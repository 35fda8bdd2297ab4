"""prefill_tick_ms.<cells>: mean host-clock ms of the window's ticks that
prefilled prompt tokens (the eager prefill passes, with whatever decode the
tick also ran), outside the traced slice."""

from perfbench.readers import window_ticks


def read(rec, spec):
    ts = [t for t in window_ticks(rec) if t.prefill_tokens > 0]
    return 1e3 * sum(t.t1 - t.t0 for t in ts) / len(ts) if ts else None
