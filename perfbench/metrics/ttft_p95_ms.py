"""ttft_p95_ms: the 95th percentile, over every request due in the window,
of the time from when it was due (the open loop's schedule) to its first
token reaching the harness; a request that never finished counts as late
beyond any limit."""

from perfbench.readers import tail_ms, ttft_s


def read(rec, spec):
    return tail_ms(ttft_s(rec))
