"""90th percentile, over the requests due in the window, of due time to
first token."""
from bench.common import stats


def read(run):
    v = stats.ranked(stats.ttfts(run.window, run.end), 90)
    return None if v is None else v * 1e3
