"""Output tokens that reached the host in the window, over its seconds."""
from bench.common import stats


def read(run):
    s = run.served
    return stats.tokens_in(s.tracked, s.t0, s.t1) / (s.t1 - s.t0)
