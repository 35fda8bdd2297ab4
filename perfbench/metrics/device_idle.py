"""device_idle.<cells>: the share, in %, of the traced slice in which no
operation ran on the device (the union of the profiler's kernel, memcpy and
memset intervals against the slice's length)."""


def read(rec, spec):
    if rec.slice is None or rec.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.slice.busy_s / rec.slice.window_s)
