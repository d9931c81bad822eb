"""End-to-end statistics over one measured window, on the host's clock.

Every request carries the second it was due and the second each of its
output tokens reached the host (the step that produced it had returned).
A request refused, failed or never started ranks as infinite: it sorts
after every served one. Where a percentile falls on such a request, the
value reported is a lower bound of its latency, the time from its due
time to the end of the run (``end``), and never less than the largest
served value.
"""
from __future__ import annotations

import math

INF = float("inf")


def percentile(values: list[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100): the smallest
    value with at least ``p``% of the values at or below it."""
    if not values:
        return math.nan
    xs = sorted(values)
    return xs[max(math.ceil(p / 100 * len(xs)) - 1, 0)]


def ranked(pairs: list[tuple[float, float]], p: float) -> float | None:
    """The ``p``-th percentile of ``(value, lower_bound)`` pairs whose
    value may be infinite: infinite values rank last, and the one a
    percentile falls on reports its lower bound, at least the largest
    finite value."""
    if not pairs:
        return None
    finite = [v for v, _ in pairs if v != INF]
    top = max(finite, default=0.0)
    xs = sorted(pairs, key=lambda vb: (vb[0] == INF, vb[0], vb[1]))
    v, b = xs[max(math.ceil(p / 100 * len(xs)) - 1, 0)]
    return v if v != INF else max(b, top)


def ttfts(reqs, end: float) -> list[tuple[float, float]]:
    """Due time to first token, per request (infinite without one, with
    ``end`` minus the due time as its bound)."""
    return [(r.stamps[0] - r.due, 0.0) if r.stamps and not r.failed
            else (INF, end - r.due) for r in reqs]


def mean_gaps(reqs, end: float) -> list[tuple[float, float]]:
    """Each request's mean gap between output tokens, (t_last - t_first) /
    (n - 1); infinite for a request that did not finish."""
    out = []
    for r in reqs:
        if r.finished and not r.failed and len(r.stamps) >= 2:
            out.append(((r.stamps[-1] - r.stamps[0])
                        / (len(r.stamps) - 1), 0.0))
        else:
            first = r.stamps[0] if r.stamps else r.due
            out.append((INF, (end - first) / max(len(r.stamps) - 1, 1)))
    return out


def gaps_in(reqs, t0: float, t1: float) -> list[float]:
    """Every gap between consecutive output tokens of every request whose
    later token reached the host in [t0, t1)."""
    out = []
    for r in reqs:
        s = r.stamps
        out.extend(s[i] - s[i - 1] for i in range(1, len(s))
                   if t0 <= s[i] < t1)
    return out


def tokens_in(reqs, t0: float, t1: float) -> int:
    return sum(1 for r in reqs for t in r.stamps if t0 <= t < t1)
