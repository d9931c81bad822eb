"""95th percentile of every gap between consecutive output tokens of every
request, in the window."""
from bench.common import stats


def read(run):
    g = stats.gaps_in(run.served.tracked, run.served.t0, run.served.t1)
    return stats.percentile(g, 95) * 1e3 if g else None
