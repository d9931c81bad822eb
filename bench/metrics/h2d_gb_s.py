"""Host-to-device copy rate in the traced part of the window: the bytes of
the trace's HtoD copies over the union of their spans."""
from bench.common import tracefile


def read(run):
    if run.trace is None or not run.trace.h2d:
        return None
    us = tracefile.union_us([(s, e) for s, e, _ in run.trace.h2d])
    return sum(b for _, _, b in run.trace.h2d) / us / 1e3 if us else None
