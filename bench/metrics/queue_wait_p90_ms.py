"""90th percentile, over the requests due in the window, of due time to the
start of the ``step()`` that admitted the request (serving/scheduler)."""
from bench.common import stats


def read(run):
    pairs = [(t.admitted - t.due, 0.0) if t.admitted is not None
             else (stats.INF, run.end - t.due) for t in run.window]
    v = stats.ranked(pairs, 90)
    return None if v is None else v * 1e3
