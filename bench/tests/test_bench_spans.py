"""The readers of the program's own spans against hand computations on a
synthetic run, None where the program recorded nothing, and the idle gaps
named by the innermost program span."""
import math
import types
from pathlib import Path

import pytest

from bench.common import metrics, serve, tracefile
from repro_torch.serving.spans import WallSpan

BENCH = Path(__file__).resolve().parents[1]
NEW = ("ring_stall_ms_mean", "ring_copy_gb_s", "ring_gb_per_step",
       "step_host_ms_mean", "sched_plan_ms_mean", "queue_span_p90_ms",
       "place_s")


def _span(spans, name, start_s, end_s, parent=-1, rid=-1, **attrs):
    spans.append(WallSpan(name, round(start_s * 1e9),
                          -1 if end_s is None else round(end_s * 1e9),
                          parent=parent, rid=rid, attrs=attrs))
    return len(spans) - 1


def _ring(copy_ms, stall_ms):
    return {"ring_bytes": 3 * 10**8, "ring_copies": 3,
            "ring_copy_ms": copy_ms, "ring_stall_ms": stall_ms}


def _run(with_spans=True):
    """Window [100, 110) s: two steps in it, one before and one after;
    requests 0-9 due in it, queued 10-90 ms, the last never admitted."""
    sp: list = []
    if with_spans:
        _span(sp, "engine.set_interval", 49.0, 49.25)
        st = _span(sp, "engine.step", 50.0, 52.0)         # set-up
        _span(sp, "engine.place", 50.0, 51.5, parent=st)
        st = _span(sp, "engine.step", 101.0, 101.1)
        _span(sp, "sched.plan", 101.0, 101.002, parent=st)
        pre = _span(sp, "engine.prefill", 101.002, 101.04, parent=st, rid=5)
        _span(sp, "prefill.compute", 101.003, 101.035, parent=pre,
              **_ring([5.0] * 3, [1.0] * 3))
        _span(sp, "decode.replay", 101.04, 101.09, parent=st,
              **_ring([6.0] * 3, [2.0, 3.0, 4.0]))
        st = _span(sp, "engine.step", 102.0, 102.1)
        _span(sp, "sched.plan", 102.0, 102.004, parent=st)
        _span(sp, "decode.replay", 102.01, 102.09, parent=st,
              **_ring([4.0] * 3, [0.0, 0.0, 1.0]))
        st = _span(sp, "engine.step", 110.0, 110.1)       # after the window
        _span(sp, "decode.replay", 110.0, 110.09, parent=st,
              **_ring([9.0] * 3, [9.0] * 3))
    tracked = []
    for rid in range(10):
        due = 100.5 + rid * 0.5
        tracked.append(types.SimpleNamespace(
            req=types.SimpleNamespace(rid=rid), due=due, in_window=True))
        if with_spans:
            end = None if rid == 9 else due + 0.01 * (rid + 1)
            _span(sp, "request.queued", due, end, rid=rid,
                  **({} if end is None else {"admitted": True}))
    served = types.SimpleNamespace(tracked=tracked, steps=[], t0=100.0,
                                   t1=110.0, program_spans=sp)
    return metrics.Run({}, {}, served)


@pytest.mark.parametrize("name,want", [
    ("ring_stall_ms_mean", (9.0 + 1.0) / 2),
    ("ring_copy_gb_s", 6e8 / 30.0 / 1e6),
    ("ring_gb_per_step", 9e8 / 2 / 1e9),
    ("step_host_ms_mean", ((100 - 32 - 50) + (100 - 80)) / 2),
    ("sched_plan_ms_mean", (2 + 4) / 2),
    ("queue_span_p90_ms", 90.0),
    ("place_s", 1.75)])
def test_reader_on_a_synthetic_run(name, want):
    got = metrics.reader(name)(_run())
    assert math.isclose(got, want, rel_tol=1e-6), (name, got, want)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_program_spans(name):
    assert metrics.reader(name)(_run(with_spans=False)) is None
    run = _run(with_spans=False)
    del run.served.program_spans            # a harness that has none
    assert metrics.reader(name)(run) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_in_the_harness_served(name):
    """The harness's own ``Served`` carries no program spans: each reader
    returns None on it rather than raise."""
    served = serve.Served(tracked=[], steps=[], t0=100.0, t1=110.0,
                          setup_s=1.0, lateness=[])
    assert (BENCH / "metrics" / f"{name}.py").is_file()
    assert metrics.reader(name)(metrics.Run({}, {}, served)) is None


def test_idle_gaps_fall_under_the_innermost_program_span():
    """Three gaps inside one ``bench.step``: the one in ``sched.plan`` is
    named for it, those outside it for ``engine.step``, none for
    ``bench.step``."""
    kernels = [{"ph": "X", "cat": "kernel", "name": "k", "ts": s, "dur": d}
               for s, d in ((1000.0, 1000.0), (5000.0, 4000.0))]
    host = [(900e-6, 10000e-6, "bench.step"),
            (920e-6, 9900e-6, "engine.step"),
            (2100e-6, 4900e-6, "sched.plan")]
    tr = tracefile.Trace({"traceEvents": kernels}, host, 0.0)
    gaps = dict(tr.idle_gaps((900.0, 10000.0)))
    assert set(gaps) == {"sched.plan", "engine.step"}
    assert math.isclose(gaps["sched.plan"], 3000e-6)
    assert math.isclose(gaps["engine.step"], 100e-6 + 1000e-6)
