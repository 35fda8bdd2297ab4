"""decode_step_ms.<cells>: host-clock ms per decode step of the window's
ticks that prefilled nothing (graph replays and the tick's host work),
outside the traced slice."""

from perfbench.readers import window_ticks


def read(rec, spec):
    ts = [t for t in window_ticks(rec) if t.prefill_tokens == 0 and t.decode_steps > 0]
    steps = sum(t.decode_steps for t in ts)
    return 1e3 * sum(t.t1 - t.t0 for t in ts) / steps if steps else None
