"""90th percentile, over the requests due in the window, of each request's
mean gap between output tokens, (t_last - t_first) / (n - 1)."""
from bench.common import stats


def read(run):
    v = stats.ranked(stats.mean_gaps(run.window, run.end), 90)
    return None if v is None else v * 1e3
