"""The traffic generator: deterministic from the seed, and every seed sends
the same sizes and gaps, block by block, in its own order."""
import collections

import numpy as np

from bench.common import traffic, workload

MIX = {"loop": "open", "rate_per_s": 2.0,
       "prompt": {"median": 256, "sigma": 0.7, "min": 16, "max": 768},
       "output": {"median": 128, "sigma": 0.5, "min": 16, "max": 256},
       "block": 16, "ttft_slo_s": 2.0, "tpot_slo_s": 0.1,
       "warmup_s": 10, "warmup_max_s": 40, "drain_s": 30}


def test_same_seed_same_requests():
    a = traffic.generate(MIX, 2**31 + 17, 1000, 64)
    b = traffic.generate(MIX, 2**31 + 17, 1000, 64)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.due_s) == (y.max_new_tokens, y.due_s)


def test_seeds_share_sizes_and_gaps_per_block():
    a = traffic.generate(MIX, 1, 1000, 64)
    b = traffic.generate(MIX, 2, 1000, 64)
    assert any(x.max_new_tokens != y.max_new_tokens for x, y in zip(a, b))
    for blk in range(4):
        sl = slice(16 * blk, 16 * blk + 16)
        for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens):
            assert (collections.Counter(map(key, a[sl]))
                    == collections.Counter(map(key, b[sl])))
        # each block spans the same time: the same gaps, reordered
        da = a[16 * blk + 15].due_s - (a[16 * blk - 1].due_s if blk else 0)
        db = b[16 * blk + 15].due_s - (b[16 * blk - 1].due_s if blk else 0)
        assert abs(da - db) < 1e-9


def test_lengths_follow_the_clipped_lognormal():
    got = workload.lognormal_lengths(256, 0.7, 16, 768, 16)
    assert got.min() >= 16 and got.max() <= 768
    assert sorted(got)[7] <= 256 <= sorted(got)[8]
    gaps = workload.exponential_gaps(2.0, 1000)
    assert abs(gaps.mean() - 0.5) < 0.02


def test_closed_loop_has_no_schedule():
    mix = dict(MIX, loop="closed", clients=4)
    assert all(r.due_s is None for r in traffic.generate(mix, 5, 100, 20))


def test_request_count_covers_the_run():
    n = traffic.request_count(MIX, 51)
    specs = traffic.generate(MIX, 9, 100, n)
    assert specs[-1].due_s > MIX["warmup_max_s"] + 51 + MIX["drain_s"]
