"""The length and gap draws of the traffic generator, after
``src/repro_torch/data/workload.py``: a Poisson process's exponential gaps
(``_session_arrivals``, lines 84-87) and the clipped lognormal lengths of
``generate_workload`` (lines 137-140). What differs: lengths and gaps are
drawn as stratified quantiles, block by block, and the seed only orders
each block: every seed then sends the same set of sizes and the same gaps,
so two seeds differ in order and in token contents, not in the amount of
work.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np


def _strata(block: int) -> np.ndarray:
    return (np.arange(block) + 0.5) / block


def lognormal_lengths(median: float, sigma: float, lo: int, hi: int,
                      block: int) -> np.ndarray:
    """``block`` lengths at the stratified quantiles of a lognormal of
    ``median`` and ``sigma``, clipped to [lo, hi] (the clip the copied
    generator applies)."""
    z = np.array([NormalDist().inv_cdf(p) for p in _strata(block)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(int)


def exponential_gaps(rate_per_s: float, block: int) -> np.ndarray:
    """``block`` gaps at the stratified quantiles of an exponential of mean
    ``1 / rate_per_s`` (a Poisson process's gaps)."""
    return -np.log1p(-_strata(block)) / rate_per_s


def blocks(values: np.ndarray, n: int, rng: np.random.Generator
           ) -> np.ndarray:
    """``n`` values: copies of ``values``, each copy in its own order from
    ``rng``."""
    reps = -(-n // len(values))
    return np.concatenate([rng.permutation(values) for _ in range(reps)])[:n]
