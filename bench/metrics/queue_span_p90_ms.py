"""90th percentile, over the requests due in the window, of the program's
``request.queued`` span: ``submit`` to the scheduler's admission of the
request (serving/scheduler). A request refused or not admitted by the end
of the run ranks last, as in ``queue_wait_p90_ms``."""
from bench.common import spans, stats


def read(run):
    queued = {s.rid: s for s in spans.of(run) if s.name == "request.queued"}
    if not queued:
        return None
    pairs = []
    for t in run.window:
        s = queued.get(t.req.rid)
        if s is not None and s.end_ns >= 0 and s.attrs.get("admitted"):
            pairs.append(((s.end_ns - s.start_ns) / 1e9, 0.0))
        else:
            start = s.start_ns / 1e9 if s is not None else t.due
            pairs.append((stats.INF, run.end - start))
    v = stats.ranked(pairs, 90)
    return None if v is None else v * 1e3
