"""Share of the summed wall time of the traced steps (the benchmark's
``bench.step`` spans) in which no kernel or copy ran on the device, in %."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.annotations("bench.step")
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us(spans) / total)
