"""setup_s: seconds from process start to the window's opening (weights,
warm-up and the load's ramp-in), by the host clock."""


def read(rec, spec):
    return rec.setup_s
