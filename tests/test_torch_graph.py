"""The decode step and the analyzer's units as CUDA graphs (``core.graphs``,
the port's counterpart of the reference's ``jax.jit``).

On the CPU: the engine's graph cache, driven through a stand-in capture
object that calls the step eagerly (a new graph after an interval switch
and after a pool reallocation, none between steps of one interval, and the
same tokens and records as the eager engine), and the counters a replay
advances, through a stand-in of the CUDA graph API. With the ``cuda``
marker, on the card: each graph replay against the same call run eagerly,
bit for bit, and the copy and launch counters against an eager run.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graph.py
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import costs, graphs  # noqa: E402
from repro_torch.core.hardware import PRESETS  # noqa: E402
from repro_torch.core.interval import OffloadPlan  # noqa: E402
from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch.serve import build_engine  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import pattern_info  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402


class StandInGraph:
    """Stands in for ``graphs.Graphed`` on the CPU: records what it was
    built with and calls the function at each replay."""

    made: list["StandInGraph"] = []

    def __init__(self, fn, inputs, counters=()):
        self.fn, self.inputs, self.counters = fn, tuple(inputs), counters
        self.replays = 0
        StandInGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.outputs = self.fn(*self.inputs)
        return self.outputs


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
    return build_engine(name, cfg, PRESETS["h100"], ecfg,
                        [0.002 * k for k in range(1, 30)], device="cpu",
                        params=params), params


def test_engine_graph_cache_and_eager_agree():
    """One capture per (interval, pool, placement): steps of one interval
    replay the same graph, an interval switch and a pool reallocation each
    capture anew. The graphed engine's static input buffer feeds the step
    the same tables as the eager call, so tokens and iteration records are
    equal."""
    StandInGraph.made = []
    eager, params = _engine("eager")
    graphed, _ = _engine("graphed", params)
    graphed._capture = StandInGraph
    for eng in (eager, graphed):
        for i, n in enumerate((5, 11, 19, 7)):
            eng.submit(Request(rid=i, prompt=np.random.default_rng(i)
                               .integers(0, 128, n).astype(np.int32),
                               max_new_tokens=9, ttft_slo_s=10.0,
                               tpot_slo_s=10.0))
        assert eng.set_interval(2)
    captures = []
    for step in range(14):
        if step == 5:                     # interval switch
            assert eager.set_interval(1) and graphed.set_interval(1)
        if step == 9:                     # the pool moves to a new buffer
            graphed.pool = graphed.pool.clone()
        eager.step()
        graphed.step()
        captures.append(graphed.decode_graph_captures)
        assert graphed.trace.iterations[-1] == eager.trace.iterations[-1]
        if eager.last_decode is not None:
            assert np.array_equal(graphed.last_decode["logits"],
                                  eager.last_decode["logits"])
    assert eager.decode_graph_captures == 0
    first = captures.index(1)
    assert captures[first:5] == [1] * (5 - first)
    assert captures[5:9] == [2] * 4 and captures[9:] == [3] * 5
    assert len(StandInGraph.made) == 3
    assert sum(g.replays for g in StandInGraph.made) == sum(
        it.decode_batch > 0 for it in graphed.trace.iterations)
    # each graph read the pool it was captured with, at the placement of
    # its interval
    assert StandInGraph.made[-1].inputs[2] is graphed.pool
    assert StandInGraph.made[1].inputs[2] is not graphed.pool
    eager.run([])
    graphed.run([])
    assert ({r.rid: r.generated for r in graphed.finished}
            == {r.rid: r.generated for r in eager.finished})
    assert graphed.prefetch_copies == eager.prefetch_copies


def test_release_placement_drops_the_graph():
    eng, _ = _engine("drop")
    eng._capture = StandInGraph
    eng.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=4, ttft_slo_s=10.0, tpot_slo_s=10.0))
    assert eng.set_interval(2)
    eng.step()
    eng.step()
    assert eng._decode_graph is not None
    assert eng.set_interval(1)
    assert eng._decode_graph is None          # freed with its placement


class _FakeCuda:
    """The slice of ``torch.cuda`` that ``graphs.Graphed`` calls, for the
    CPU: streams and a graph that do nothing."""

    class Stream:
        def wait_stream(self, other):
            pass

    class CUDAGraph:
        replays = 0

        def replay(self):
            _FakeCuda.CUDAGraph.replays += 1

    @staticmethod
    def current_stream():
        return _FakeCuda.Stream()

    @staticmethod
    def stream(s):
        return contextlib.nullcontext()

    @staticmethod
    def graph(g):
        return contextlib.nullcontext()


def test_graph_counters_add_captured_counts_per_replay(monkeypatch):
    """A capture adds nothing to the counters (its warm-up and recording
    run the Python wrappers, whose counts are taken back); each replay adds
    the counts one call added."""
    for name in ("Stream", "CUDAGraph", "current_stream", "stream",
                 "graph"):
        monkeypatch.setattr(torch.cuda, name, getattr(_FakeCuda, name))

    class Ring:
        copies = 7

    ring = Ring()

    def step(x):
        DA.launches += 4                   # what the kernels' wrappers do
        FA.launches += 1
        ring.copies += 2
        return x + 1

    monkeypatch.setattr(DA, "launches", 10)
    monkeypatch.setattr(FA, "launches", 0)
    g = graphs.Graphed(step, (torch.zeros(2),), [(ring, "copies")])
    assert (DA.launches, FA.launches, ring.copies) == (10, 0, 7)
    for k in range(1, 4):
        g.replay()
        assert (DA.launches, FA.launches, ring.copies) == (10 + 4 * k, k,
                                                           7 + 2 * k)
    assert torch.equal(g.outputs, torch.ones(2))


class _CapturingCuda(_FakeCuda):
    """``_FakeCuda`` with events and a capture flag, for a ``WeightStream``
    on the CPU: its copies are real CPU copies into the slots."""

    capturing = False

    class Stream(_FakeCuda.Stream):
        def __init__(self, *a, **k):
            pass

        def wait_event(self, ev):
            pass

    class Event:
        def __init__(self, *a, **k):
            pass

        def record(self, stream=None):
            pass

    @staticmethod
    def current_stream(device=None):
        return _CapturingCuda.Stream()

    @staticmethod
    @contextlib.contextmanager
    def graph(g):
        _CapturingCuda.capturing = True
        try:
            yield
        finally:
            _CapturingCuda.capturing = False

    @staticmethod
    def is_current_stream_capturing():
        return _CapturingCuda.capturing


def _ring_runtime(monkeypatch, interval, layers=6):
    """A runtime whose walks drive a ``WeightStream`` as on a GPU, with the
    CUDA calls stood in on the CPU (``_CapturingCuda``), beside the same
    model with nothing offloaded; and both placed parameter trees."""
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)

    for name in ("Stream", "Event", "CUDAGraph", "current_stream", "stream",
                 "graph", "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, getattr(_CapturingCuda, name))
    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=64, heads=2,
                        layers=layers, d_ff=128, vocab=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    _, units = pattern_info(cfg)
    ref = OffloadRuntime(model, OffloadPlan(units, NO_OFFLOAD), "cpu")
    rt = OffloadRuntime(model, OffloadPlan(units, interval), "cpu")
    placed = split_model_params(params, rt.plan)
    rt.device = torch.device("cuda")       # the walks take the ring's path
    from repro_torch.core.memory_manager import WeightStream
    rt._stream = WeightStream(placed["blocks"]["offloaded"],
                              torch.device("cpu"))
    rt._stream.prime()
    return cfg, rt, placed, ref, split_model_params(params, ref.plan)


def _slots_hold_first_units(ring):
    """Between two walks, units 0 and 1 sit in slots 0 and 1."""
    for slot in range(ring.n_prime):
        for d, h in zip(tree_leaves(ring.slots[slot]),
                        tree_leaves(ring.host)):
            assert torch.equal(d, h[slot]), slot


@pytest.mark.parametrize("interval", [2, 3, 6], ids=["g3", "g2", "g1"])
def test_walks_prime_the_next_walk(monkeypatch, interval):
    """Each walk ends by priming the ring: between walks the slots hold
    units 0 and 1 (unit 0 alone at one group), the next walk takes them
    without copying them again, and every walk computes what the model
    computes with nothing offloaded, prefill and decode steps alike. A
    priming's copies count once, when issued: a walk adds G copies, and
    every walk but the first after ``place`` counts as primed."""
    cfg, rt, placed, ref, ref_placed = _ring_runtime(monkeypatch, interval)
    ring, g = rt._stream, rt.plan.num_groups
    assert (ring.copies, ring.walks, ring.primed_walks) == (ring.n_prime,
                                                            0, 0)
    _slots_hold_first_units(ring)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    logits, caches, _ = rt.prefill(placed, {"tokens": tokens}, 16)
    want, ref_caches, _ = ref.prefill(ref_placed, {"tokens": tokens}, 16)
    assert torch.equal(logits, want)
    pos = torch.full((2,), 9, dtype=torch.int32)
    for step in range(3):
        c0 = ring.copies
        tok = want.argmax(-1).to(torch.int32)
        logits, caches = rt.decode_step(placed, tok, pos, caches)
        want, ref_caches = ref.decode_step(ref_placed, tok, pos, ref_caches)
        assert torch.equal(logits, want), step
        assert ring.copies - c0 == g
        assert (ring.walks, ring.primed_walks) == (step + 2, step + 1)
        _slots_hold_first_units(ring)
        pos = pos + 1
    assert ring.copy_bytes == ring.copies * ring.unit_bytes
    assert (rt.walks, rt.primed_walks) == (ring.walks, ring.primed_walks)


def test_captured_walk_primes_around_each_replay(monkeypatch):
    """A walk captured by ``Graphed`` waits for the primed units without
    taking them (the eager warm-up primed the ring, and the graph's first
    replay takes that priming); each replay takes the priming and primes
    again on the host, so it counts as one primed walk of G copies, and
    a ring that a caller's own walk (``begin``) used is primed before the
    replay. A graph holds one walk of a ring."""
    cfg, rt, placed, *_ = _ring_runtime(monkeypatch, 2)
    ring, g = rt._stream, rt.plan.num_groups
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(2))
    _, caches, _ = rt.prefill(placed, {"tokens": tokens}, 12)
    tok = torch.zeros(1, dtype=torch.int32)
    pos = torch.full((1,), 8, dtype=torch.int32)
    w0 = ring.walks
    graph = rt.capture_decode(placed, tok, pos, caches)
    # the warm-up walked and primed; the capture took nothing
    assert (ring.walks, ring._primed) == (w0 + 1, ring.n_prime)
    assert len(graph._hooks) == 1
    for k in range(1, 4):
        c0 = ring.copies
        graph.replay()
        assert ring.copies - c0 == g           # G-2 in the graph, 2 primed
        assert (ring.walks, ring.primed_walks) == (w0 + 1 + k, w0 + k)
        assert ring._primed == ring.n_prime
    ring.begin()                 # a caller's walk overwrites the slots
    ring.end()
    assert ring._primed == 0
    c0 = ring.copies
    graph.replay()               # primed first, then as before
    assert ring.copies - c0 == g + ring.n_prime
    assert ring.primed_walks == ring.walks - 2

    def twice(x):
        rt.decode_step(placed, tok, pos, caches)
        return rt.decode_step(placed, tok, pos, caches)

    with pytest.raises(RuntimeError, match="one pair"):
        graphs.Graphed(twice, (None,))
    with pytest.raises(RuntimeError, match="needs a graph captured"):
        graphs.around_replay(ring, lambda: None, lambda: None)


@pytest.mark.parametrize("interval", [2, "none"])
def test_engine_without_a_ring_counts_no_walks(interval):
    """On the CPU, and with nothing offloaded, there is no ring: the
    engine serves as before and its ring counters stay 0."""
    from repro_torch.core.interval import NO_OFFLOAD

    eng, _ = _engine("no_ring")
    for i, n in enumerate((5, 11)):
        eng.submit(Request(rid=i, prompt=np.arange(n, dtype=np.int32),
                           max_new_tokens=4, ttft_slo_s=10.0,
                           tpot_slo_s=10.0))
    assert eng.set_interval(NO_OFFLOAD if interval == "none" else interval)
    eng.run([])
    assert len(eng.finished) == 2
    assert (eng.ring_walks, eng.ring_primed_walks, eng.prefetch_copies) == (
        0, 0, 0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs capture the card's kernels")
    return torch.device("cuda")


def _card_model():
    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                        layers=12, d_ff=512, vocab=1024)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _placed(cfg, params, interval, dev):
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)
    _, units = pattern_info(cfg)
    rt = OffloadRuntime(build_model(cfg), OffloadPlan(units, interval), dev)
    return rt, rt.place(split_model_params(params, rt.plan))


def _step_inputs(cfg, dev, seed, batch=4, seq=64):
    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    gen = torch.Generator(dev).manual_seed(seed)
    pool = decode_pool(cfg, build_model(cfg).virtual_kv, batch, seq, dev)
    pool.copy_(torch.randn(pool.shape, generator=gen, device=dev))
    d = paged_decode_inputs(pool, batch, seq)
    tokens = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                           device=dev, dtype=torch.int32)
    return [tokens, d.pos, pool, d.block_tables, d.context_lens,
            d.write_frames, d.write_offsets]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [(6,), (1,), (6, 2)],
                         ids=["interval6", "interval1", "after_switch"])
def test_decode_step_replay_is_bitwise_eager(cuda, schedule):
    """The decode step replayed from its graph gives the eager step's bits:
    logits and every pool page, over two steps with new inputs copied into
    the graph's static buffers; ``after_switch`` captures at interval 6,
    then places and captures interval 2."""
    cfg, params = _card_model()
    for interval in schedule:
        rt, placed = _placed(cfg, params, interval, cuda)
        step = functools.partial(rt.paged_decode_step, placed)
        eager_in = _step_inputs(cfg, cuda, seed=1)
        graph_in = [t.clone() for t in eager_in]
        g = graphs.Graphed(step, graph_in, [(rt._stream, "copies")])
        for k in range(2):
            if k:                      # the next token, one position on
                for inp in (eager_in, graph_in):
                    inp[0].copy_((inp[0] * 7 + 3) % cfg.vocab_size)
            want, _ = step(*eager_in)
            got, _ = g.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (interval, k)
            assert torch.equal(graph_in[2], eager_in[2]), (interval, k)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_analyzer_unit_replay_is_bitwise_eager(cuda, phase):
    """The analyzer's timed units at two buckets: the hidden state of a
    graph replay equals the eager unit's, bit for bit."""
    from repro_torch.core.analyzer import PerformanceAnalyzer

    cfg, _ = _card_model()
    an = PerformanceAnalyzer(cfg, PRESETS["h100"])
    for batch, seq in ((1, 64), (4, 256)):
        fn, args = an.unit_call(batch, seq, phase)
        want = fn(*args).clone()
        got = graphs.Graphed(fn, args).replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (phase, batch, seq)


@pytest.mark.cuda
def test_replay_counters_match_an_eager_run(cuda):
    """Three eager steps and three replays advance ``prefetch_copies`` and
    the decode kernel's ``launches`` by the same amounts."""
    cfg, params = _card_model()
    rt, placed = _placed(cfg, params, 6, cuda)
    step = functools.partial(rt.paged_decode_step, placed)
    inputs = _step_inputs(cfg, cuda, seed=2)

    def deltas(call):
        c0, l0 = rt.prefetch_copies, DA.launches
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        return rt.prefetch_copies - c0, DA.launches - l0

    eager = deltas(lambda: step(*inputs))
    g = graphs.Graphed(step, inputs, [(rt._stream, "copies")])
    assert deltas(g.replay) == eager == (3 * 2, 3 * cfg.num_layers)


@pytest.mark.cuda
def test_weight_ring_stream_is_never_a_pooled_capture_stream(cuda):
    """PyTorch hands out default-priority streams round robin from a pool
    of 32: the ring's side stream must not be one of them, or a graph
    captured on a pooled stream would run the ring's copies in line with
    its compute. A walk begun on the side stream itself is refused."""
    from repro_torch.core.memory_manager import WeightStream

    host = {"w": torch.zeros((2, 1024), dtype=torch.uint8).pin_memory()}
    ws = WeightStream(host, cuda)
    pooled = [torch.cuda.Stream() for _ in range(64)]
    assert all(s != ws.stream for s in pooled)
    with torch.cuda.stream(ws.stream):
        with pytest.raises(RuntimeError, match="side stream"):
            ws.begin()


@pytest.mark.cuda
def test_capture_with_an_unjoined_side_stream_raises(cuda):
    """A capture that forks a side stream and never joins it fails, and the
    failure is raised: nothing falls back to an eager call."""
    x = torch.ones(8, device=cuda)
    calls = []

    def forked(t):
        calls.append(1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            return t * 2

    with pytest.raises(RuntimeError):
        graphs.Graphed(forked, (x,))
    assert len(calls) == 2                # the warm-up and the capture
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.full_like(x, 2.0))



@pytest.mark.cuda
def test_placement_link_times_the_engines_own_stack(cuda):
    """``profile_engine.placement_link`` times walks of the ring's copies
    out of the pinned stack that the measured engine then streams from:
    the walks read the adopted runtime's host leaves, which stay the
    engine's through its steps, and add no prefetch: the only ones are the
    placement's priming of the ring and the priming again after the walks,
    which overwrote its slots."""
    from repro_torch.launch import profile_engine as P

    cfg, _ = _card_model()
    _, units = pattern_info(cfg)
    page_bytes = 16 * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(max_batch=4, max_seq=64, page_size=16,
                        hbm_budget_bytes=OffloadPlan(units, 4).device_bytes(
                            costs.unit_weight_bytes(cfg)) + 8 * page_bytes)
    pl = P.placement_link(cfg, P.memory_interval(cfg, ecfg), latency_s=1e-5)
    rt, walks = pl["runtime"], pl["walks"]
    assert rt.plan.interval == 4 and walks["groups"] == rt.plan.num_groups
    assert len(walks["unit_copy_s"]) == P.LINK_WALKS
    assert all(t > 0 for t in walks["unit_copy_s"])
    assert pl["link"]["slowest_gb_s"] <= pl["link"]["median_gb_s"]
    assert rt.prefetch_copies == 2 * rt._stream.n_prime
    eng = build_engine("adopted", cfg, PRESETS["h100"], ecfg,
                       [0.002 * k for k in range(1, 30)], device="cuda",
                       params=pl["params"])
    eng.adopt_placement(rt, pl["placed"])
    stack = eng._rt()[0]._stream.host
    assert [t.data_ptr() for t in tree_leaves(stack)] == walks["host_ptrs"]
    for i in range(2):
        eng.submit(Request(rid=i, prompt=np.arange(9 + i, dtype=np.int32),
                           max_new_tokens=3, ttft_slo_s=10.0,
                           tpot_slo_s=10.0))
    assert eng.set_interval(4)
    eng.run([])
    assert eng._rt()[0] is rt and eng.prefetch_copies > 0


# ---------------------------------------------------------------------------
# The dense-cache grouped decode (every model family) as a graph
# ---------------------------------------------------------------------------

FAMILY_LAYERS = {"jamba-1.5-large-398b": 16, "xlstm-125m": 4,
                 "seamless-m4t-medium": 4, "paligemma-3b": 4}


def _family_prefilled(arch, interval, dev, batch=2, seq=12):
    """A reduced model of ``arch`` placed at ``interval`` on ``dev``, and
    its prefill's split caches, encoder positions and next inputs."""
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)
    from repro_torch.models.frontends import stub_embeddings

    cfg = reduce_config(get_config(arch), d_model=128, heads=4,
                        layers=FAMILY_LAYERS[arch], d_ff=256, vocab=512)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    _, units = pattern_info(cfg)
    rt = OffloadRuntime(model, OffloadPlan(units, interval), dev)
    placed = rt.place(split_model_params(params, rt.plan))
    inputs, n_front = {}, 0
    if cfg.encoder_layers:
        inputs["enc_embeds"] = stub_embeddings(cfg, batch, 2 * seq, gen,
                                               "cpu").to(dev)
    elif cfg.frontend is not None:
        n_front = cfg.frontend.num_positions
        inputs["frontend_embeds"] = stub_embeddings(cfg, batch, n_front, gen,
                                                    "cpu").to(dev)
    inputs["tokens"] = torch.randint(0, cfg.vocab_size,
                                     (batch, seq - n_front), generator=gen
                                     ).to(dev)
    logits, caches, enc_pos = rt.prefill(placed, inputs, seq + 4)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((batch,), seq, dtype=torch.int32, device=dev)
    return rt, placed, caches, enc_pos, tok, pos


def _replay_against_eager(rt, placed, caches, enc_pos, tok, pos, steps=3):
    """Capture the dense decode step over ``caches``, then step an eager
    copy and the graph side by side: logits, every cache leaf and the
    prefetch copies per step (one per group on a GPU, none on the CPU)
    must agree."""
    eager = tree_map(torch.clone, caches)
    g_tok, g_pos = tok.clone(), pos.clone()
    g = rt.capture_decode(placed, g_tok, g_pos, caches, enc_pos)
    for a, b in zip(tree_leaves(caches), tree_leaves(eager)):
        assert torch.equal(a, b)            # the warm-up call was undone
    per_step = rt.plan.num_groups if rt._stream is not None else 0
    for _ in range(steps):
        c0 = rt.prefetch_copies
        want, _ = rt.decode_step(placed, tok, pos, eager, enc_pos)
        assert rt.prefetch_copies - c0 == per_step
        got, same = g.replay()
        assert same is caches
        assert rt.prefetch_copies - c0 == 2 * per_step
        assert torch.equal(got, want)
        for a, b in zip(tree_leaves(caches), tree_leaves(eager)):
            assert torch.equal(a, b)
        tok = want.argmax(-1).to(torch.int32)
        pos = pos + 1
        g_tok.copy_(tok)
        g_pos.copy_(pos)


class WarmingStandIn(StandInGraph):
    """``StandInGraph`` that, like ``graphs.Graphed``, calls the function
    once when built (the capture's eager warm-up)."""

    def __init__(self, fn, inputs, counters=()):
        super().__init__(fn, inputs, counters)
        fn(*self.inputs)


@pytest.mark.parametrize("arch", list(FAMILY_LAYERS))
def test_dense_decode_capture_undoes_warmup_and_replays(arch, monkeypatch):
    """On the CPU, through a stand-in that warms up as a capture does:
    ``capture_decode`` leaves the caches as they were, and each replay
    advances them in place as the eager step advances a copy."""
    monkeypatch.setattr(graphs, "Graphed", WarmingStandIn)
    _replay_against_eager(*_family_prefilled(arch, 2, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_LAYERS))
def test_dense_decode_replay_is_bitwise_eager(cuda, arch):
    """On the card: the dense grouped decode captured as one CUDA graph
    (offloaded units in pinned host memory, one prefetch copy per group on
    the side stream) gives the eager step's logits and caches bit for bit
    over three steps, recurrent states and cross caches included."""
    args = _family_prefilled(arch, 2, cuda)
    assert args[0]._stream is not None and args[0].plan.num_groups > 0
    _replay_against_eager(*args)
    torch.cuda.synchronize()
