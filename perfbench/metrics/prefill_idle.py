"""prefill_idle.<cells>: the share, in %, of the traced slice in which no
operation ran on the device while the engine's thread was inside an
``engine.prefill`` range (the program's span around one prefill pass, from
building its input to fetching the first token it yields): the exact
intersection of the slice's idle time with those ranges, a part of
``device_idle``.  No reading where the trace holds no ``engine.*`` range
(an engine without spans)."""

PREFILL = "engine.prefill"


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(rec, spec):
    s = rec.slice
    if s is None or s.window_s <= 0 or not any(name.startswith("engine.") for name, _, _ in s.host):
        return None
    spans = merged((max(ts, s.t0), min(ts + dur, s.t1)) for name, ts, dur in s.host if name == PREFILL)
    idle = sum(b - a for a, b in spans) - overlap_us(spans, s.busy_intervals())
    return 100.0 * idle / (s.t1 - s.t0)
