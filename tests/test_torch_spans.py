"""The serving engine's wall-clock spans (``serving.spans``) and the weight
ring's byte counter and timing events (``core.memory_manager``).

On the CPU, a tiny engine: with spans off nothing is recorded and no clock
is read; spans on and off serve the same tokens and the same modeled trace;
the span tree is well formed; the serve CLI's ``--trace-out`` file holds
the modeled and the wall-clock process; the ring's byte counter advances
per graph replay like ``copies``. With the ``cuda`` marker, on the card: each unit copy timed by
the ring's events in a graph replay against the profiler's memcpys.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import costs, graphs  # noqa: E402
from repro_torch.core.hardware import PRESETS  # noqa: E402
from repro_torch.core.interval import OffloadPlan  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import tree_leaves  # noqa: E402
from repro_torch.models.transformer import pattern_info  # noqa: E402
from repro_torch.serving import spans as spans_mod  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

# the spans every step of the tiny trace below opens, and those that only
# some steps or the set-up open
STEP_SPANS = {"sched.plan", "kv.stream_in", "decode.tables", "decode.replay",
              "decode.logits_to_host", "decode.sample", "engine.record"}
OTHER_SPANS = {"engine.prefill", "prefill.compute", "prefill.scatter",
               "prefill.logits_to_host", "kv.writeback",
               "decode.graph_capture", "engine.set_interval", "engine.place"}


class StandInGraph:
    """Stands in for ``graphs.Graphed`` on the CPU: calls the function at
    each replay and keeps the counters it was given."""

    def __init__(self, fn, inputs, counters=()):
        self.fn, self.inputs, self.counters = fn, tuple(inputs), counters

    def replay(self):
        return self.fn(*self.inputs)


def _engine(name, params=None):
    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=64, heads=2,
                        layers=4, d_ff=128, vocab=128)
    _, units = pattern_info(cfg)
    page_bytes = 8 * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(max_batch=3, max_seq=32, page_size=8,
                        hbm_budget_bytes=OffloadPlan(units, 1).device_bytes(
                            costs.unit_weight_bytes(cfg)) + 6 * page_bytes,
                        host_kv_bytes=24 * page_bytes)
    if params is None:
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")
    eng = build_engine(name, cfg, PRESETS["h100"], ecfg,
                       [0.002 * k for k in range(1, 30)], device="cpu",
                       params=params)
    eng._capture = StandInGraph
    return eng, params


def _serve(eng) -> int:
    """A trace that admits four requests over two steps, streams host KV
    pages and writes some back; returns the number of ``step()`` calls."""
    assert eng.set_interval(2)
    for i, n in enumerate((5, 11, 19, 7)):
        eng.submit(Request(rid=i, prompt=np.random.default_rng(i)
                           .integers(0, 128, n).astype(np.int32),
                           max_new_tokens=6, ttft_slo_s=10.0,
                           tpot_slo_s=10.0))
    steps = 0
    while eng.scheduler.has_work() or eng._active_batch() > 0:
        eng.step()
        steps += 1
    return steps


@pytest.fixture(scope="module")
def served():
    """The same requests served with spans off and on."""
    off, params = _engine("off")
    on, _ = _engine("on", params)
    on.trace.spans_on = True
    return off, _serve(off), on, _serve(on)


def test_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a span site read the clock with spans off")

    monkeypatch.setattr(spans_mod, "perf_counter_ns", clock)
    eng, _ = _engine("quiet")
    assert _serve(eng) > 0
    assert eng.trace.wall_spans == [] and eng.trace.take_wall_spans() == []
    eng.submit(Request(rid=9, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=2, ttft_slo_s=10.0, tpot_slo_s=10.0))
    eng.trace.spans_on = True                 # the patch is live
    with pytest.raises(AssertionError, match="read the clock"):
        eng.step()


def test_spans_on_and_off_serve_the_same(served):
    off, n_off, on, n_on = served
    assert n_on == n_off
    assert ({r.rid: r.generated for r in on.finished}
            == {r.rid: r.generated for r in off.finished})
    want, got = off.trace.to_dict(), on.trace.to_dict()
    want.pop("engine")
    got.pop("engine")
    assert got == want
    assert on.trace.audit().ok and off.trace.audit().ok


def test_span_tree_is_well_formed(served):
    _, _, on, n_steps = served
    spans = on.trace.wall_spans
    assert all(s.end_ns >= s.start_ns >= 0 for s in spans)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and not p.is_request
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, \
                (s.name, p.name)
    roots = [s for s in spans if s.name == "engine.step"]
    assert len(roots) == n_steps and all(s.parent < 0 for s in roots)
    assert [s.attrs["iteration"] for s in roots] == list(range(n_steps))
    names = {s.name for s in spans}
    assert STEP_SPANS | OTHER_SPANS | {"engine.step", "request.queued"} \
        == names
    for root_i, root in enumerate(spans):
        if root.name != "engine.step":
            continue
        kids = {s.name for s in spans if s.parent == root_i}
        assert STEP_SPANS <= kids, STEP_SPANS - kids
    # one request.queued per admitted request, ending inside the step that
    # admitted it; the spans of one request share its rid
    queued = [s for s in spans if s.name == "request.queued"]
    admitted = {rid: rec.index for rec in on.trace.iterations
                for rid in rec.admitted}
    assert sorted(s.rid for s in queued) == sorted(admitted)
    for s in queued:
        assert s.is_request and s.attrs["admitted"]
        root = roots[admitted[s.rid]]
        assert root.start_ns <= s.end_ns <= root.end_ns
    prefills = [s for s in spans if s.name == "engine.prefill"]
    assert sorted(s.rid for s in prefills) == sorted(admitted)


def test_serve_cli_trace_out_holds_both_clocks(tmp_path, capsys):
    """``launch/serve.py --trace-out`` turns the spans on, and its Perfetto
    file loads with the modeled clock's process and the wall clock's: a
    root span per step, a request slice opened and closed per request."""
    from repro_torch.launch import serve as serve_cli

    path = tmp_path / "trace.json"
    out = serve_cli.main(["--device", "cpu", "--requests", "3",
                          "--trace-out", str(path)])
    capsys.readouterr()
    ev = json.loads(path.read_text())["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in ev
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert sorted(procs.values()) == ["engine:e0 (modeled clock)",
                                      "engine:e0 (wall clock)"]
    wall = next(p for p, n in procs.items() if "wall" in n)
    steps = [e for e in ev if e["pid"] == wall and e["name"] == "engine.step"]
    assert steps and all(e["ph"] == "X" and e["dur"] > 0 for e in steps)
    queued = sorted(e["ph"] for e in ev
                    if e["pid"] == wall and e.get("cat") == "request")
    assert out["finished"] == 3 and queued == ["b"] * 3 + ["e"] * 3


class _FakeCuda:
    """The slice of ``torch.cuda`` that ``graphs.Graphed`` and
    ``WeightStream`` call, for the CPU: streams, events and a graph that do
    nothing."""

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

        def wait_event(self, ev):
            pass

    class Event:
        def __init__(self, *a, **k):
            pass

        def record(self, stream=None):
            pass

    class CUDAGraph:
        def replay(self):
            pass

    @staticmethod
    def current_stream(device=None):
        return _FakeCuda.Stream()

    @staticmethod
    def stream(s):
        return contextlib.nullcontext()

    @staticmethod
    def graph(g):
        return contextlib.nullcontext()


def test_ring_byte_counter_advances_per_replay(monkeypatch):
    """``copy_bytes`` counts the unit's bytes per issue and, registered as a
    replay counter like ``copies``, advances by one walk's bytes per
    replay; a capture adds nothing."""
    from repro_torch.core.memory_manager import WeightStream

    for name in ("Stream", "Event", "CUDAGraph", "current_stream", "stream",
                 "graph"):
        monkeypatch.setattr(torch.cuda, name, getattr(_FakeCuda, name))
    host = {"w": torch.randn(3, 4, 5), "b": torch.randn(3, 7,
                                                        dtype=torch.bfloat16)}
    ring = WeightStream(host, torch.device("cpu"))
    assert ring.unit_bytes == 4 * 5 * 4 + 7 * 2

    def walk(x):
        ring.begin()
        for g in range(3):
            slot = ring.issue(g)
            x = x + ring.acquire(slot)["w"].sum()
            ring.release(slot)
        ring.end()
        return x

    g = graphs.Graphed(walk, (torch.zeros(()),),
                       [(ring, "copies"), (ring, "copy_bytes")])
    assert (ring.copies, ring.copy_bytes) == (0, 0)
    for k in range(1, 4):
        g.replay()
        assert (ring.copies, ring.copy_bytes) == (3 * k,
                                                  3 * k * ring.unit_bytes)


def test_decode_graph_counts_the_ring_bytes_and_keys_on_spans():
    """The engine registers the ring's byte counter with its decode graph,
    and captures again when spans are switched on; the replay's span says
    whether its walk was primed."""

    class Ring:
        copies = copy_bytes = walks = primed_walks = 0
        timed = False
        unit_bytes = 1

    eng, _ = _engine("counted")
    eng.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=5, ttft_slo_s=10.0, tpot_slo_s=10.0))
    assert eng.set_interval(2)
    eng.step()
    ring = eng._runtime._stream = Ring()
    eng._decode_graph = None
    eng.step()
    graph = eng._decode_graph[1]
    assert [(o is ring, n) for o, n in graph.counters] == [
        (True, "copies"), (True, "copy_bytes")]
    eng.step()
    assert eng.decode_graph_captures == 2
    eng.trace.spans_on = True
    eng.step()
    assert eng.decode_graph_captures == 3 and ring.timed
    replay = [s for s in eng.trace.wall_spans if s.name == "decode.replay"]
    assert replay[-1].attrs == {"ring_bytes": 0, "ring_copies": 0,
                                "ring_primed": 0}
    taken = eng.trace.take_wall_spans()
    assert replay[-1] in taken and eng.trace.wall_spans == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring's events time the card's "
                    "copies")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timed_unit_copies_match_the_profiler(cuda):
    """In one profiled replay of a timed decode graph (qwen2.5-3b's width,
    6 layers at interval 3: two 154 MB units streamed), each unit's copy
    time read from the ring's events lies within 10% of the span of that
    unit's memcpys in the profiler's trace, and no stall exceeds the
    replay."""
    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=2048, heads=16,
                        layers=6, d_ff=11008, vocab=1024)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    _, units = pattern_info(cfg)
    rt = OffloadRuntime(model, OffloadPlan(units, 3), cuda)
    placed = rt.place(split_model_params(params, rt.plan))
    ring = rt._stream
    ring.timed = True
    pool = decode_pool(cfg, model.virtual_kv, 4, 64, cuda)
    d = paged_decode_inputs(pool, 4, 64)
    tokens = torch.zeros(4, dtype=torch.int32, device=cuda)
    g = graphs.Graphed(
        lambda *a: rt.paged_decode_step(placed, *a),
        (tokens, d.pos, pool, d.block_tables, d.context_lens,
         d.write_frames, d.write_offsets),
        [(ring, "copies"), (ring, "copy_bytes")])
    g.replay()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
    timed = ring.timings()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    h2d = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in ev if e.get("cat") == "gpu_memcpy"
                 and "HtoD" in e.get("name", ""))
    leaves = len(tree_leaves(ring.slots[0]))
    assert len(timed) == rt.plan.num_groups == 2
    assert len(h2d) == len(timed) * leaves
    for g_i, (copy_ms, stall_ms) in enumerate(timed):
        unit = h2d[g_i * leaves:(g_i + 1) * leaves]
        prof_ms = (unit[-1][1] - unit[0][0]) / 1e3
        assert abs(copy_ms - prof_ms) <= 0.1 * prof_ms, (g_i, copy_ms,
                                                          prof_ms)
        assert 0.0 <= stall_ms <= start.elapsed_time(end)
    # later card tests measure allocated memory: leave none behind
    del g, prof, placed, rt, ring, pool, d
    gc.collect()
    torch.cuda.empty_cache()
