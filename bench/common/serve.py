"""One cell served through ``ServingEngine.submit`` and ``step`` on the
host's wall clock.

Requests are submitted when their due time has passed; ``step`` is called
while the engine has work, and the loop sleeps until the next arrival when
it has none. Each output token is stamped when the ``step`` that produced
it returns: the step has synchronized by then, because its logits came to
the host. Every request is timed from its due time, not from when it was
submitted. Nothing here reads the engine's modeled clock.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from bench.common import traffic, weights

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"
# the SLO grid the engine's records are generated over: 2 ms to 238 ms
SLO_GRID_S = [k * 2e-3 for k in range(1, 120)]
# rids of the priming requests, past any the traffic sends
PRIME_RID = 1 << 40


def load_config(name: str, directory: Path = CONFIG_DIR) -> dict:
    cfg = json.loads((directory / f"{name}.json").read_text())
    cfg["name"] = name
    return cfg


def model_config(m: dict):
    """The program's ``ModelConfig`` for a configuration's ``model``
    group."""
    from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig
    kw = {k: v for k, v in m.items() if k not in ("moe", "name")}
    moe = m.get("moe")
    if moe:
        kw["moe"] = MoEConfig(**moe)
        kw["pattern"] = (BlockSpec(mixer="attention", mlp="moe"),)
    return ModelConfig(name=m.get("name", "bench"), **kw)


def _shapes(tree) -> object:
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [_shapes(v) for v in tree]


@dataclasses.dataclass
class Tracked:
    """A request as the benchmark sees it: due time, the wall time each
    output token reached the host, and the start of the step that admitted
    it."""
    spec: traffic.Spec
    req: object
    due: float
    submitted: float | None = None
    admitted: float | None = None
    stamps: list = dataclasses.field(default_factory=list)
    finished: bool = False
    failed: bool = False
    in_window: bool = False

    @property
    def done(self) -> bool:
        return self.finished or self.failed


@dataclasses.dataclass
class StepRec:
    """One ``step()``: its wall span and what the engine recorded for it."""
    start: float
    end: float
    decode_batch: int
    interval: int
    host_weight_bytes: int
    context_lens: list
    prefill_lens: list
    prefill_ms: list
    decode_ms: list


@dataclasses.dataclass
class Served:
    """What a served cell leaves for the metric readers and the check."""
    tracked: list
    steps: list
    t0: float
    t1: float
    setup_s: float
    lateness: list
    profiler: object = None
    trace_window: tuple | None = None
    # the traced part's host spans (perf_counter start, end, name), and
    # time.time() - time.perf_counter() as the profiler started
    host_spans: list = dataclasses.field(default_factory=list)
    epoch_offset: float = 0.0


def build_engine(cfg: dict, mix: dict, seed: int, device: str):
    """The engine a cell serves with: the configuration's model at its
    sizes, with weights made on ``device`` from ``seed``, records and clock
    from the ``h100_calibrated`` preset in model mode, the HBM budget rule,
    host KV tier and held interval (``fixed_interval``) of the
    configuration."""
    from repro_torch.core import costs
    from repro_torch.core.analyzer import PerformanceAnalyzer
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.launch.serve import record_buckets
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    m, e = cfg["model"], cfg["engine"]
    mcfg = model_config(m)
    model = build_model(mcfg)
    _, units = pattern_info(mcfg)
    page = e["page_size"]
    page_bytes = page * costs.kv_cache_bytes(mcfg, 1, 1)
    pages_per_slot = -(-mix["max_seq"] // page)
    kv_bytes = (e["kv_slot_share"] * mix["max_batch"] * pages_per_slot
                * page_bytes)
    interval = e["fixed_interval"]
    # the engine accounts the held interval's resident units and ring slots
    # against the budget; the rest of the budget is KV pages
    weight_dev = OffloadPlan(units, interval).device_bytes(
        costs.unit_weight_bytes(mcfg))
    ecfg = EngineConfig(
        max_batch=mix["max_batch"], max_seq=mix["max_seq"], page_size=page,
        hbm_budget_bytes=weight_dev + kv_bytes,
        host_kv_bytes=e["host_kv_pages"] * page_bytes, autotune=False)
    hw = PRESETS[e["hardware"]]
    an = PerformanceAnalyzer(mcfg, hw, measure="model", device=device)
    batches, seqs = record_buckets(ecfg)
    params = weights.make(m, seed, device)
    if _shapes(params) != _shapes(model.spec):
        raise RuntimeError("the benchmark's weight layout is not the "
                           "program's parameter tree")
    eng = ServingEngine(cfg["name"], model, hw,
                        an.generate_record(SLO_GRID_S, batches, seqs,
                                           "prefill"),
                        an.generate_record(SLO_GRID_S, batches, seqs,
                                           "decode"),
                        an.layer_times, ecfg, device=device, params=params)
    del params
    if not eng.set_interval(interval):
        raise RuntimeError(f"the engine refused interval {interval}")
    info = {"units": units, "page_bytes": page_bytes,
            "hbm_budget_bytes": ecfg.hbm_budget_bytes,
            "host_kv_bytes": ecfg.host_kv_bytes, "interval_fixed": interval,
            "pool_frames": int(eng.pool.shape[0])}
    return eng, info


def _request(spec: traffic.Spec, due_rel: float):
    from repro_torch.serving.request import Request
    return Request(rid=spec.index, prompt=spec.prompt,
                   max_new_tokens=spec.max_new_tokens,
                   ttft_slo_s=spec.ttft_slo_s, tpot_slo_s=spec.tpot_slo_s,
                   arrival_s=due_rel)


def prime(eng, vocab: int, rng: np.random.Generator) -> None:
    """Build the kernels and run the engine's first prefill, decode steps
    and graph capture on two short requests, served to the end."""
    from repro_torch.serving.request import Request
    for i in range(2):
        eng.submit(Request(rid=PRIME_RID + i,
                           prompt=rng.integers(0, vocab, 16).astype(np.int32),
                           max_new_tokens=4, ttft_slo_s=60.0,
                           tpot_slo_s=1.0))
    while eng.scheduler.has_work() or eng._active_batch() > 0:
        eng.step()


def _has_work(eng) -> bool:
    return eng.scheduler.has_work() or eng._active_batch() > 0


def serve(eng, mix: dict, specs: list, seconds: float, t_process: float,
          profile: bool = False) -> Served:
    """Serve ``specs`` as ``mix`` says: the warm-up, then a window of
    ``seconds``, then until every request due in the window has finished or
    ``drain_s`` has passed. The warm-up lasts at least ``warmup_s`` and
    ends once (in an open loop) no request waits in the scheduler's queue,
    or at ``warmup_max_s``; the window opens at the next request due (an
    open loop) or at once (a closed loop, whose callers send their next
    request as the last one finishes). With ``profile``,
    ``torch.profiler`` traces the card's activity alone (kernels and
    copies; no host ops, whose recording would slow the host) from the end
    of the warm-up until the first step that starts after the window has
    closed and leaves every request due in the window admitted: stopping
    the profiler holds the host for seconds, so it stops where no request
    of the window still waits for admission, and the drain's deadline moves
    by the time it took. The harness keeps its own host spans of the traced
    part: each ``step()``, each wait for an arrival, and the loop between
    them."""
    from repro_torch.serving.request import State

    open_loop = mix["loop"] == "open"
    t_start = time.perf_counter()
    pending = list(specs)              # not yet due, in order
    live: list[Tracked] = []
    tracked: list[Tracked] = []
    by_rid: dict[int, Tracked] = {}
    due_of = lambda s: t_start + s.due_s
    clients_due = [] if open_loop else [t_start] * mix["clients"]
    # the window: unknown until the warm-up ends
    t0 = t1 = deadline = float("inf")

    def warm(now: float) -> bool:
        """Whether the warm-up is over at ``now``."""
        if now - t_start >= mix["warmup_max_s"]:
            return True
        quiet = not open_loop or not (eng.queue or eng.scheduler.preempted)
        return now - t_start >= mix["warmup_s"] and quiet
    steps: list[StepRec] = []
    lateness: list[float] = []
    prof = None
    trace_window = None
    spans: list[tuple[float, float, str]] = []
    epoch_offset = 0.0
    if profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])

    def tracing() -> bool:
        return trace_window is not None and trace_window[1] is None

    def submit(spec, due):
        now = time.perf_counter()
        t = Tracked(spec, _request(spec, due - t_start), due, submitted=now,
                    in_window=t0 <= due < t1)
        eng.submit(t.req)
        if t.in_window:
            lateness.append(now - due)
        live.append(t)
        tracked.append(t)
        by_rid[t.req.rid] = t

    while True:
        now = time.perf_counter()
        if t0 == float("inf") and warm(now):
            if prof is not None:
                # the profiler takes seconds to start: it starts in the
                # set-up, and the window opens after it has
                prof.start()
                now = time.perf_counter()
                epoch_offset = time.time() - time.perf_counter()
                trace_window = (now, None)
            t0 = (next(due_of(s) for s in pending if due_of(s) >= now)
                  if open_loop else now)
            t1 = t0 + seconds
            deadline = t1 + mix["drain_s"]
        if open_loop:
            while pending and due_of(pending[0]) <= now:
                spec = pending.pop(0)
                submit(spec, due_of(spec))
        else:
            ready = [d for d in clients_due if d <= now]
            clients_due = [d for d in clients_due if d > now]
            for d in sorted(ready):
                if pending:
                    submit(pending.pop(0), d)
        window_reqs = [t for t in tracked if t.in_window]
        if now >= t1 and all(t.done for t in window_reqs):
            break
        if now >= deadline:
            for t in window_reqs:
                if not t.done:
                    t.failed = True
            break
        if not _has_work(eng):
            nxt = (due_of(pending[0]) if open_loop and pending
                   else min(clients_due, default=None))
            if nxt is None:
                break
            start = time.perf_counter()
            time.sleep(max(0.0, min(nxt, deadline) - start))
            if tracing():
                spans.append((start, time.perf_counter(),
                              "bench.wait_for_arrival"))
            continue
        n_rec = len(eng.trace.iterations)
        n_pre, n_dec = len(eng.prefill_ms), len(eng.decode_ms)
        start = time.perf_counter()
        eng.step()
        end = time.perf_counter()
        if tracing():
            spans.append((start, end, "bench.step"))
        rec = (eng.trace.iterations[-1]
               if len(eng.trace.iterations) > n_rec else None)
        ctx = []
        if rec is not None and rec.decode_batch and eng.last_decode:
            ld = eng.last_decode
            ctx = [int(p) + 1 for p, a in zip(ld["pos"], ld["active"]) if a]
        admitted = [by_rid[r] for r in (rec.admitted if rec else ())
                    if r in by_rid]
        steps.append(StepRec(
            start, end, rec.decode_batch if rec else 0,
            rec.interval if rec else -1, eng.host_weight_bytes, ctx,
            [len(t.spec.prompt) for t in admitted], eng.prefill_ms[n_pre:],
            eng.decode_ms[n_dec:]))
        still = []
        for t in live:
            n = len(t.req.generated)
            t.stamps.extend([end] * (n - len(t.stamps)))
            if t.admitted is None and t.req.admitted_s is not None:
                t.admitted = start
            if t.req.state is State.FINISHED:
                t.finished = True
            elif t.req.state is State.REJECTED:
                t.failed = True
            if t.done:
                if not open_loop:
                    clients_due.append(end)
            else:
                still.append(t)
        live = still
        if tracing() and start >= t1 and all(
                t.admitted is not None or t.done
                for t in tracked if t.in_window):
            trace_window = (trace_window[0], end)
            prof.stop()
            deadline += time.perf_counter() - end
    if tracing():
        trace_window = (trace_window[0], time.perf_counter())
        prof.stop()
    return Served(tracked=tracked, steps=steps, t0=t0, t1=t1,
                  setup_s=t0 - t_process, lateness=lateness,
                  profiler=prof, trace_window=trace_window,
                  host_spans=spans, epoch_offset=epoch_offset)
