"""Percentiles, window rates and the FLOP / byte counts against hand
computations."""
import dataclasses
import math

from bench.common import flops, peaks, stats, tracefile


@dataclasses.dataclass
class R:
    due: float
    stamps: list
    finished: bool = True
    failed: bool = False


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_failures_rank_last_and_report_a_bound():
    pairs = [(float(i), 0.0) for i in range(1, 10)] + [(stats.INF, 42.0)]
    assert stats.ranked(pairs, 90) == 9.0
    assert stats.ranked(pairs, 100) == 42.0
    # a bound below the largest served value never reports less than it
    assert stats.ranked([(7.0, 0.0), (stats.INF, 1.0)], 100) == 7.0


def test_window_statistics():
    reqs = [R(0.0, [0.5, 0.7, 1.0]), R(1.0, [1.2, 2.2]),
            R(2.0, [], finished=False, failed=True)]
    ttft = stats.ttfts(reqs, 5.0)
    assert ttft[0] == (0.5, 0.0)
    assert math.isclose(ttft[1][0], 0.2)
    assert ttft[2] == (stats.INF, 3.0)
    gaps = [v for v, _ in stats.mean_gaps(reqs, 5.0)]
    assert math.isclose(gaps[0], 0.25) and math.isclose(gaps[1], 1.0)
    assert gaps[2] == stats.INF
    got = sorted(stats.gaps_in(reqs, 0.6, 2.0))
    assert len(got) == 2 and math.isclose(got[0], 0.2)
    assert math.isclose(got[1], 0.3)
    assert stats.tokens_in(reqs, 0.0, 1.1) == 3


def test_roofline_counts():
    nbytes, fl = peaks.flash_prefill_cost(1024, 32, 32, 128)
    q = 32 * 1024 * 128
    assert nbytes == 2 * (4 * q)
    assert fl == 4 * 32 * (1024 * 1025 // 2) * 128
    nbytes, fl = peaks.paged_decode_cost([10, 20], 4, 8, 2, 64, 8)
    assert nbytes == 30 * 2 * 64 * 4 + 2 * 4 * 8 * 64 * 2 + 4 * 8 * 4 + 16
    assert fl == 4 * 30 * 8 * 64
    t, by = peaks.bound_s(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")


def test_model_flops():
    m = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "d_ff": 16, "vocab_size": 32}
    per_layer = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16
    assert flops.layer_matmul_params(m) == per_layer
    assert flops.decode_token_flops(m, 5) == (
        2 * (2 * per_layer + 4 * 2 * 4 * 5) + 2 * 8 * 32)
    moe = dict(m, moe={"num_experts": 4, "top_k": 2})
    assert flops.layer_matmul_params(moe) == (
        8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 8 * 4 + 2 * 3 * 8 * 16)
    assert flops.prefill_flops(m, 3) == (
        2 * (2 * per_layer * 3 + 4 * 2 * 4 * 6) + 2 * 8 * 32)


def test_trace_unions_and_gaps():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30,
         "dur": 10, "args": {"bytes": 4000}},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step",
         "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 16,
         "dur": 10}]}
    t = tracefile.Trace(trace)
    assert t.busy_us() == 25
    assert t.busy_us([(0, 12)]) == 12
    assert t.kernel_us(("k1",)) == 10
    assert t.h2d == [(30.0, 40.0, 4000.0)]
    gaps = dict((n, v) for n, v in t.idle_gaps((0, 50)))
    assert math.isclose(gaps["aten::copy_"], 15e-6)
    assert math.isclose(gaps["bench.step"], 10e-6)


def test_host_spans_land_on_the_trace_clock():
    """The harness's perf_counter spans are put on the trace's clock
    (microseconds since the epoch less ``baseTimeNanoseconds``), with or
    without a base in the trace."""
    epoch_offset = 1.7e9               # time.time() - time.perf_counter()
    step = (100.0, 100.00005)          # perf_counter seconds: 50 us
    at = (epoch_offset + step[0]) * 1e6
    for base_ns in (None, 1.6e18):
        shift = 0.0 if base_ns is None else base_ns / 1e3
        trace = {"traceEvents": [
            {"ph": "X", "cat": "kernel", "name": "k", "ts": at - shift + 10,
             "dur": 20}]}
        if base_ns is not None:
            trace["baseTimeNanoseconds"] = base_ns
        t = tracefile.Trace(trace, [(*step, "bench.step")], epoch_offset)
        (s, e), = t.annotations("bench.step")
        assert math.isclose(e - s, 50, abs_tol=1e-3)
        assert math.isclose(t.busy_us([(s, e)]), 20, abs_tol=1e-3)
        assert t.host_cover == 1.0
        gaps = dict((n, v) for n, v in t.idle_gaps((s, e)))
        assert math.isclose(gaps["bench.step"], 30e-6, abs_tol=1e-9)


def test_the_check_samples_many_slots():
    """The sample holds the longest request and then others until it has
    both ``min_tokens`` tokens and ``min_requests`` requests."""
    import numpy as np
    from bench.common import check, traffic

    @dataclasses.dataclass
    class Req:
        generated: list

    @dataclasses.dataclass
    class T:
        spec: object
        req: Req
        in_window: bool = True
        finished: bool = True

    def t(n_prompt, n_out):
        spec = traffic.Spec(0, np.zeros(n_prompt, np.int32), n_out, 1.0,
                            1.0, 0.0)
        return T(spec, Req([1] * n_out))
    reqs = [t(10, 500)] + [t(10, 20) for _ in range(30)]
    reqs.append(T(reqs[1].spec, reqs[1].req, in_window=False))
    got = check.sample(reqs, 3, min_tokens=300, min_requests=16)
    assert got[0] is reqs[0] and len(got) == 16
    assert all(x.in_window for x in got)
    got = check.sample(reqs, 3, min_tokens=900, min_requests=4)
    assert sum(len(x.req.generated) for x in got) >= 900
    assert len(check.sample(reqs, 3, 10**6, 100)) == 31
