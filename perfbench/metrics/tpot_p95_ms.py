"""tpot_p95_ms: the 95th percentile, over every request due in the window,
of (last token time - first token time) / (tokens - 1)."""

from perfbench.readers import tail_ms, tpot_s


def read(rec, spec):
    return tail_ms(tpot_s(rec))
