"""Where a decode iteration's, an incremental chunk step's, or the disk
tier's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine \\
        [--iters 4] [--out chiprun_out/profile_engine]
    PYTHONPATH=src python -m repro_torch.launch.profile_engine --incremental
    PYTHONPATH=src python -m repro_torch.launch.profile_engine --disk

Serves the full-width qwen2.5-3b (random weights, seed 0) with the engine
configuration that ``chip_smoke.py`` also builds through ``smoke_engine``
(interval autotuning under a memory ceiling of interval 6 plus 40 KV pages,
a 128-page host KV tier, TPOT 20 ms), warms up until all 8 requests decode,
then traces ``--iters`` decode iterations with ``torch.profiler``. With
``--incremental`` the engine prefills in 256-token chunks through the paged
chunk-prefill kernel: after a short warm-up run it serves
``LONG_PROMPT_LENS`` and traces every step until each prompt is prefilled
(the chunk steps, each of which also carries the decode iteration). With
``--disk`` it serves the disk-pressure trace of ``disk_engine`` with the
async copy-stage data plane (after a warm-up run of the same trace on an
engine with the same weights) and traces every step of it. Prints one JSON
object: the window's wall time (host clock, synchronized), the
device time covered by kernels, by host<->device copies, by both at once
and by either, the resulting device idle share, the paged decode and chunk
attention kernels' time and share of kernel time, and the kernels that took
the most device time; ``--disk`` adds the data plane's wall seconds (copies
on the serving thread and on its background worker) and staged pages. The
Chrome trace is written under ``--out``. Needs a GPU.

The module also holds what ``chip_smoke.py``'s measured phases call:
``calibrate`` (the per-unit times, the host link and the LM-head rest
measured on the card, and the ``H100_CALIBRATED`` values fitted from them),
``placement_link`` (the measured engine's own placement, and the host link
fitted from the slowest of several walks of the ring's copies out of it),
``measured_records`` (the analyzer's wall-clock records on the card),
``measured_engine`` (the smoke configuration served against them, its
clock ``calibrated_clock``, streaming from that placement),
``baseline_intervals`` / ``policy_decode`` (the paper's Select-N vs
DeepSpeed vs FlexGen comparison, run on the card), and ``moe_engine``
(the MoE decoder, dbrx-132b at full width and 4 layers, on the link of
its own placement).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core.analyzer import (MeasuredTimes, PerformanceAnalyzer,
                                       _layer_times, _time_fn, decode_pool,
                                       determinism_check,
                                       paged_decode_inputs, unit_time_stats)
from repro_torch.core.baselines import (FlexGenDecision, deepspeed_plan,
                                        flexgen_decision,
                                        flexgen_equivalent_interval)
from repro_torch.core.coordinator import max_interval_for_memory
from repro_torch.core.graphs import Graphed
from repro_torch.core.hardware import H100, PRESETS, HardwareModel
from repro_torch.core.interval import (NO_OFFLOAD, LayerTimes, OffloadPlan,
                                       optimal_interval,
                                       iter_time_with_interval_kv)
from repro_torch.core.memory_manager import OffloadRuntime
from repro_torch.core.record import PerformanceRecord
from repro_torch.core.slo import SLO_GRANULARITY_S
from repro_torch.launch.serve import build_engine, record_buckets
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.models.transformer import pattern_info
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                       place_weights)
from repro_torch.serving.request import Request, State

PROMPT_LENS = (512, 300, 128, 64, 480, 200, 33, 17)
# prompts that span several 256-token chunks, for incremental prefill
LONG_PROMPT_LENS = (1000, 760, 130, 40)
MAX_SEQ = 1024
PAGE_SIZE = 16
TPOT_SLO_S = 0.02
# the records' SLO grid: every 2 ms step up to 238 ms
SLO_GRID = [0.002 * k for k in range(1, 120)]


def smoke_config(prefill_chunk_tokens: int = 0,
                 incremental_prefill: bool = False, arch: str = "qwen2.5-3b"
                 ) -> tuple[ModelConfig, EngineConfig]:
    """The full-width model and engine configuration of the smoke and
    profile runs (see ``smoke_engine``); ``arch`` an attention decoder."""
    cfg = get_config(arch)
    _, units = pattern_info(cfg)
    page_bytes = PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(
        max_batch=8, max_seq=MAX_SEQ, page_size=PAGE_SIZE,
        hbm_budget_bytes=OffloadPlan(units, 6).device_bytes(
            costs.unit_weight_bytes(cfg)) + 40 * page_bytes,
        host_kv_bytes=128 * page_bytes, autotune=True,
        prefill_chunk_tokens=prefill_chunk_tokens,
        incremental_prefill=incremental_prefill)
    return cfg, ecfg


def smoke_engine(device: str = "cuda", *, prefill_chunk_tokens: int = 0,
                 incremental_prefill: bool = False, arch: str = "qwen2.5-3b",
                 params: dict | None = None):
    """The full-width engine of the smoke and profile runs.

    HBM holds the resident units of interval 6 plus 40 KV pages: the memory
    ceiling keeps the autotuner at a finite interval, so offloaded units
    live in pinned host memory and stream every iteration. A 20 ms TPOT
    leaves interval 6 as the tuner's only feasible choice on the modeled
    clock (~15 ms vs ~18 ms at 5), so the requests' KV pages overflow the
    device pool and cold prefixes stream from the host tier.
    ``prefill_chunk_tokens`` / ``incremental_prefill`` are the
    ``EngineConfig`` fields of chunked prefill: with both, long prompts
    (``LONG_PROMPT_LENS``) prefill chunk by chunk through the paged
    chunk-prefill kernel over pages that sit partly on the host tier.
    ``arch`` swaps the model at the same settings (gemma-2b: head_dim 256);
    ``params`` serves given weights instead of seed 0's."""
    cfg, ecfg = smoke_config(prefill_chunk_tokens, incremental_prefill, arch)
    return build_engine("smoke", cfg, PRESETS["h100"], ecfg, SLO_GRID,
                        device=device, params=params)


def smoke_requests(vocab: int, max_new_tokens: int, rng: np.random.Generator,
                   prompt_lens: tuple[int, ...] = PROMPT_LENS,
                   tpot_slo_s: float = TPOT_SLO_S) -> list[Request]:
    """One request per ``prompt_lens`` entry, random prompt tokens."""
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=max_new_tokens, ttft_slo_s=2.0,
                    tpot_slo_s=tpot_slo_s)
            for i, n in enumerate(prompt_lens)]


# The MoE decoder: dbrx-132b at full width (d_model 6144, 48 heads over 8
# KV heads, head_dim 128, d_ff 10752, 16 experts top-4, vocab 100352,
# capacity factor 1.25), its depth reduced from 40 layers to MOE_LAYERS.
# The engine keeps a host master copy of every weight and pins each
# offloaded unit: one layer is 6.52 GB in bf16 (experts 6.34 GB), so 40
# layers would need 261 GB of host memory; 4 layers hold 26.1 GB of blocks,
# 2.47 GB of untied embedding and LM head, and one 6.52 GB pinned unit.
MOE_ARCH = "dbrx-132b"
MOE_LAYERS = 4


def moe_config(layers: int = MOE_LAYERS
               ) -> tuple[ModelConfig, EngineConfig, int]:
    """The MoE engine's model, configuration and interval: dbrx-132b at
    full width and ``layers`` layers (reduced: host memory), ``max_batch``
    8, ``max_seq`` 1024, page 16, a 128-page host KV tier, held at the
    interval of one group (the depth in units: one unit streams), with HBM
    for that interval's resident units and the weight ring's two slots plus
    40 KV pages. The ring's two slots make every offloading interval but 1
    cost as much device memory as keeping all four units at 4 layers, so no
    memory ceiling forces the interval: the engine holds it, as
    ``disk_engine`` holds its own."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=layers)
    _, units = pattern_info(cfg)
    page_bytes = PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(
        max_batch=8, max_seq=MAX_SEQ, page_size=PAGE_SIZE,
        hbm_budget_bytes=OffloadPlan(units, units).device_bytes(
            costs.unit_weight_bytes(cfg)) + 40 * page_bytes,
        host_kv_bytes=128 * page_bytes)
    return cfg, ecfg, units


def moe_hardware(cfg: ModelConfig, units: dict, link: dict
                 ) -> HardwareModel:
    """The MoE engine's preset: the datasheet ``h100`` with the compute
    and HBM efficiency fitted to this model's unit times on the card
    (``calibrate_units``, ``fit_calibration``) and the host link of the
    placement's slowest ring walk (``link``)."""
    fitted = fit_calibration(
        cfg, units["prefill"]["mean_s"], units["decode"]["mean_s"],
        {"bw_bytes_s": link["host_link_bw"],
         "latency_s": link["host_link_latency_s"]})
    return dataclasses.replace(PRESETS["h100"], **fitted)


def moe_engine(cfg: ModelConfig, ecfg: EngineConfig, placement: dict,
               hw: HardwareModel, rest_mem_eff: float,
               device: str = "cuda") -> ServingEngine:
    """The MoE engine (``moe_config``) serving the weights of ``placement``
    (``placement_link`` at the configuration's interval) from that
    placement, its records on ``SLO_GRID`` and its clock (model mode) the
    preset ``hw`` (``moe_hardware``: compute terms fitted on the card, the
    placement's link) with the rest term fitted apart (``rest_mem_eff``,
    ``calibrated_clock``), so both model the buffers it streams from and
    the card's compute. Serve it at ``measured_tpot_slo(..., interval=)``
    at its interval, the smallest SLO at which the decode record makes that
    interval the smallest feasible one (a keeping-up tuner's choice)."""
    an = PerformanceAnalyzer(cfg, hw, measure="model", device=device)
    batches, seqs = record_buckets(ecfg)
    eng = ServingEngine("moe", build_model(cfg), hw,
                        an.generate_record(SLO_GRID, batches, seqs, "prefill"),
                        an.generate_record(SLO_GRID, batches, seqs, "decode"),
                        calibrated_clock(cfg, hw, rest_mem_eff, device),
                        ecfg, device=device, params=placement["params"])
    eng.adopt_placement(placement["runtime"], placement["placed"])
    return eng


# the disk-pressure trace (tests/differential/test_async_data_plane.py's
# fig18 trace at page 16, token counts doubled so the page counts match)
DISK_MAX_SEQ = 96
DISK_INTERVAL = 6


def disk_engine(device: str = "cuda", *, async_plane: bool = False,
                backing_path: str | None = None, params: dict | None = None,
                cfg: ModelConfig | None = None):
    """The engine of the disk-tier runs: full-width qwen2.5-3b (or ``cfg``)
    at page 16 and a fixed interval 6 (set here; no autotuning), with HBM
    for interval 6's resident units plus 4 KV pages, a host tier of 2
    pages, a disk tier of 16 and preemption on. The host tier holds exactly
    the long request's spill, so parking it forces a disk retirement.
    ``async_plane`` queues the copies for the next iteration boundary;
    ``backing_path`` maps the disk pool onto a file; ``params`` reuses a
    parameter tree (one 3B init for several engines)."""
    cfg = cfg or get_config("qwen2.5-3b")
    _, units = pattern_info(cfg)
    page_bytes = PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(
        max_batch=4, max_seq=DISK_MAX_SEQ, page_size=PAGE_SIZE,
        hbm_budget_bytes=OffloadPlan(units, DISK_INTERVAL).device_bytes(
            costs.unit_weight_bytes(cfg)) + 4 * page_bytes,
        host_kv_bytes=2 * page_bytes, disk_kv_bytes=16 * page_bytes,
        disk_backing_path=backing_path, preemption=True,
        async_data_plane=async_plane)
    eng = build_engine(f"disk{'_async' if async_plane else ''}", cfg,
                       PRESETS["h100"], ecfg, SLO_GRID, device=device,
                       params=params)
    if not eng.set_interval(DISK_INTERVAL):
        raise RuntimeError("the disk engine refused its interval")
    return eng


def disk_requests(eng, rng: np.random.Generator
                  ) -> tuple[list[Request], list[Request]]:
    """The pressure trace: S0 (8 prompt + 24 new tokens) and L1 (32 + 32,
    2 device + 2 host pages) first, then four shorts of 8 + 8. A short
    cannot spill (L1's spill fills the host pool) and L1's two streamed
    pages exceed the one page the short would add, so admitting it parks
    L1, whose pages the host cannot absorb: L1's spill retires to disk.

    The shorts' TPOT is ``test_async_data_plane._tpot_short``'s analytic
    rule (between the iterations that stream one page and two), rounded
    up to the decode record's SLO grid (``SLO_GRANULARITY_S``, 2 ms). At
    full width one page costs about 9 us of a 15 ms iteration at interval
    6, so the rule itself lands inside one grid step, and the record would
    reject the shorts (it needs interval 7 for that bucket). S0 and L1 get
    a TPOT a hundred times the two-page iteration."""
    pb, seq = eng.kv.page_bytes, eng.ecfg.max_seq
    dt_1 = iter_time_with_interval_kv(eng.times_fn(4, seq, "decode"),
                                      eng.interval, 1 * pb)
    dt_2 = iter_time_with_interval_kv(eng.times_fn(1, seq, "decode"),
                                      eng.interval, 2 * pb)
    assert dt_1 < dt_2
    short = (math.ceil((dt_1 + dt_2) / 2 / SLO_GRANULARITY_S)
             * SLO_GRANULARITY_S)
    loose = 100 * dt_2
    vocab = eng.cfg.vocab_size

    def req(rid, plen, new, tpot):
        return Request(rid=rid, prompt=rng.integers(0, vocab, plen).astype(
            np.int32), max_new_tokens=new, ttft_slo_s=10.0, tpot_slo_s=tpot)

    first = [req(9, 8, 24, loose), req(0, 32, 32, loose)]
    return first, [req(i, 8, 8, short) for i in range(1, 5)]


def serve_disk_trace(eng, first: list[Request], later: list[Request]
                     ) -> dict:
    """Submit ``first``, step twice, submit ``later`` and serve to the end
    (``run`` drains the rest and completes every staged copy)."""
    for r in first:
        eng.submit(r)
    eng.step()
    eng.step()
    for r in later:
        eng.submit(r)
    return eng.run([])


# ---------------------------------------------------------------------------
# Calibration, measured records and the baselines on the card
# ---------------------------------------------------------------------------

# the (batch, seq) bucket each calibrated factor is fitted at: prefill at one
# 1024-token prompt is compute-bound, decode at batch 8 memory-bound
CALIBRATION_BUCKETS = {"prefill": (1, MAX_SEQ), "decode": (8, MAX_SEQ)}
# the small copy whose time, beside a whole unit's, gives the link's latency
LINK_PROBE_BYTES = 4096
# the (batch, seq) decode bucket of the baselines comparison
BASELINE_BUCKET = (8, MAX_SEQ)


def measure_link(nbytes: int) -> dict:
    """Pinned host-to-device copies of ``nbytes`` and of
    ``LINK_PROBE_BYTES`` out of one buffer, each the median of 10
    CUDA-event timings after a warm-up: the link's bandwidth is the slope
    between the two, its latency the intercept."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def copy_s(n: int) -> float:
        dst[:n].copy_(src[:n], non_blocking=True)
        ts = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst[:n].copy_(src[:n], non_blocking=True)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        return float(np.median(ts))

    full, probe = copy_s(nbytes), copy_s(LINK_PROBE_BYTES)
    bw = (nbytes - LINK_PROBE_BYTES) / (full - probe)
    return {"bytes": nbytes, "copy_s": full, "probe_bytes": LINK_PROBE_BYTES,
            "probe_copy_s": probe, "gb_s": nbytes / full / 1e9,
            "bw_bytes_s": bw, "latency_s": full - nbytes / bw}


def fit_calibration(cfg: ModelConfig, prefill_s: float, decode_s: float,
                    link: dict) -> dict:
    """``H100_CALIBRATED``'s four values: the efficiency factors that make
    the datasheet roofline (``HardwareModel.exec_time``) give the measured
    prefill unit time from its FLOPs and the measured decode unit time from
    its bytes, at ``CALIBRATION_BUCKETS``, and the measured link."""
    p, _ = pattern_info(cfg)
    (pb, ps), (db, ds) = (CALIBRATION_BUCKETS["prefill"],
                          CALIBRATION_BUCKETS["decode"])
    flops = sum(costs.layer_flops(cfg, pb, ps, ps, j) for j in range(p))
    nbytes = sum(costs.layer_act_bytes(cfg, db, 1, ds, j) for j in range(p))
    return {"compute_eff": flops / (H100.peak_flops * prefill_s),
            "mem_eff": nbytes / (H100.hbm_bw * decode_s),
            "host_link_bw": link["bw_bytes_s"],
            "host_link_latency_s": link["latency_s"]}


def unit_enqueue_s(an: PerformanceAnalyzer, batch: int, seq: int) -> dict:
    """The wall-clock decode unit's host enqueue time (the call returning,
    no synchronize) beside its CUDA-event time (first launch to last),
    medians of 10 calls after a warm-up, called eagerly and as a replay of
    its CUDA graph (the analyzer's timed call). Equal times mean the card
    waits on the host: the call is launch-bound."""
    fn, args = an.unit_call(batch, seq, "decode")
    out = {}
    for name, call in (("eager", lambda: fn(*args)),
                       ("graph", Graphed(fn, args).replay)):
        call()
        enqueue, event = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            call()
            end.record()
            enqueue.append(time.perf_counter() - t0)
            end.synchronize()
            event.append(start.elapsed_time(end) / 1e3)
        out[f"{name}_enqueue_s"] = float(np.median(enqueue))
        out[f"{name}_event_s"] = float(np.median(event))
    return out


def eager_unit_stats(an: PerformanceAnalyzer, batch: int, seq: int,
                     phase: str, iters: int = 5) -> dict:
    """``unit_time_stats`` of the unit called eagerly, one launch at a time
    from Python (how the analyzer timed it before it timed graph replays):
    each of ``iters`` measurements is one warm-up call and the median of 3
    synchronized calls."""
    fn, args = an.unit_call(batch, seq, phase)
    ts = []
    for _ in range(iters):
        fn(*args)
        one = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            one.append(time.perf_counter() - t0)
        ts.append(float(np.median(one)))
    ts = np.asarray(ts)
    return {"mean_s": float(ts.mean()), "std_s": float(ts.std()),
            "cv": float(ts.std() / ts.mean())}


def measure_rest(an: PerformanceAnalyzer, batch: int) -> float:
    """The per-iteration rest on the card: the final norm and the LM head
    over ``batch`` decode rows, timed as the analyzer times a unit (graph
    replays on a GPU)."""
    m1, params = an._single_unit_params()
    cfg = m1.cfg
    x = torch.zeros((batch, 1, cfg.d_model), dtype=params["embed"].dtype,
                    device=an.device)

    def rest(h):
        return T.lm_logits(cfg, params,
                           L.apply_norm(cfg, params["final_norm"], h))

    return _time_fn(rest, x, device=an.device)


def fit_rest(cfg: ModelConfig, rest_s: float) -> float:
    """The HBM fraction that makes the analyzer's model-mode rest term (the
    LM head's weight bytes over the datasheet bandwidth) give the measured
    rest: the layers' ``mem_eff`` is fitted from a unit of many small
    kernels, the rest is one large bandwidth-bound GEMV."""
    return cfg.padded_vocab() * cfg.d_model * 2 / (H100.hbm_bw * rest_s)


def calibrated_clock(cfg: ModelConfig, hw: HardwareModel,
                     rest_mem_eff: float | None = None,
                     device: str = "cuda"):
    """The modeled clock of ``hw`` (the analyzer in model mode); with
    ``rest_mem_eff``, its rest term is the one fitted apart (``fit_rest``),
    every other term the preset's."""
    clock = PerformanceAnalyzer(cfg, hw, measure="model", device=device)
    if rest_mem_eff is None:
        return clock.layer_times
    rest = PerformanceAnalyzer(
        cfg, dataclasses.replace(hw, mem_eff=rest_mem_eff), measure="model",
        device=device)
    return lambda b, s, phase: dataclasses.replace(
        clock.layer_times(b, s, phase),
        t_rest_s=rest.measure_times(b, s, phase).t_rest_s)


def calibrate_units(cfg: ModelConfig, iters: int = 3) -> dict:
    """The unit times ``fit_calibration`` and ``fit_rest`` take, measured
    on the card for any model as ``calibrate`` measures them for qwen: the
    decode unit at (8, 1024) and the prefill unit at (1, 1024) as graph
    replays (``unit_time_stats``, ``iters`` each), the decode unit's
    enqueue beside its device time (``unit_enqueue_s``), and the LM-head
    rest at the decode batch with its fitted HBM fraction."""
    db, ds = CALIBRATION_BUCKETS["decode"]
    pb, ps = CALIBRATION_BUCKETS["prefill"]
    an = PerformanceAnalyzer(cfg, H100, measure="wallclock")
    decode = unit_time_stats(an, db, ds, "decode", iters)
    prefill = unit_time_stats(an, pb, ps, "prefill", iters)
    rest_s = measure_rest(an, db)
    return {"decode": {"batch": db, "seq": ds, **decode,
                       **unit_enqueue_s(an, db, ds)},
            "prefill": {"batch": pb, "seq": ps, **prefill},
            "rest": {"batch": db, "s": rest_s, "mem_eff": fit_rest(cfg,
                                                                   rest_s)}}


def calibrate(cfg: ModelConfig) -> dict:
    """Measure on the card what ``H100_CALIBRATED`` is fitted from: the
    per-unit decode time at (8, 1024) with its CV over 5 measurements
    (``determinism_check``), the prefill unit at (1, 1024) the same way, and
    the host link over one unit's weight bytes; returns them with the
    fitted values, the decode unit's enqueue and device times
    (``unit_enqueue_s``), beside each unit the same unit called eagerly
    (``eager_unit_stats``), and the rest at the decode batch with its own
    fitted HBM fraction (``measure_rest``, ``fit_rest``)."""
    db, ds = CALIBRATION_BUCKETS["decode"]
    pb, ps = CALIBRATION_BUCKETS["prefill"]
    decode = determinism_check(cfg, db, ds)
    an = PerformanceAnalyzer(cfg, H100, measure="wallclock")
    prefill = unit_time_stats(an, pb, ps, "prefill")
    link = measure_link(costs.unit_weight_bytes(cfg))
    rest_s = measure_rest(an, db)
    return {"card": torch.cuda.get_device_name(0),
            "rest": {"batch": db, "s": rest_s,
                     "mem_eff": fit_rest(cfg, rest_s)},
            "decode": {"batch": db, "seq": ds, **decode,
                       **unit_enqueue_s(an, db, ds),
                       "eager": eager_unit_stats(an, db, ds, "decode")},
            "prefill": {"batch": pb, "seq": ps, **prefill,
                        "eager": eager_unit_stats(an, pb, ps, "prefill")},
            "link": link,
            "fitted": fit_calibration(cfg, prefill["mean_s"],
                                      decode["mean_s"], link)}


# walks of the ring's copies the placement's link is fitted from
LINK_WALKS = 10


def engine_weights(cfg: ModelConfig, device: str = "cuda") -> dict:
    """The weights an engine of ``cfg`` draws by default (``torch.Generator``
    seed 0 on ``device``), as the host master copy it keeps."""
    gen = torch.Generator(device).manual_seed(0)
    return tree_map(lambda t: t.cpu(), build_model(cfg).init(gen, device))


def memory_interval(cfg: ModelConfig, ecfg: EngineConfig) -> int:
    """The largest interval ``ecfg``'s HBM budget holds: the one the
    measured engine's decode record gives its largest bucket at the SLO it
    certifies."""
    _, units = pattern_info(cfg)
    return max_interval_for_memory(units, costs.unit_weight_bytes(cfg),
                                   ecfg.hbm_budget_bytes)


def ring_walks(rt: OffloadRuntime, walks: int = LINK_WALKS) -> dict:
    """``walks`` walks over every group, each group's offloaded unit copied
    out of ``rt``'s pinned stack as the weight ring copies it (one copy
    per leaf on the ring's side stream, into the slot of the group), after
    one warm-up walk; CUDA events around each walk. Returns the unit's
    bytes, each walk's seconds per unit and the stack's host addresses
    (the copies are not counted as prefetches)."""
    ws = rt._stream
    groups = rt.plan.num_groups
    unit_bytes = sum(t[0].numel() * t[0].element_size()
                     for t in tree_leaves(ws.host))
    per_unit = []
    torch.cuda.synchronize()
    with torch.cuda.stream(ws.stream):
        for _ in range(walks + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for g in range(groups):
                tree_map(lambda d, h: d.copy_(h[g], non_blocking=True),
                         ws.slots[g % 2], ws.host)
            end.record()
            end.synchronize()
            per_unit.append(start.elapsed_time(end) / 1e3 / groups)
    return {"unit_bytes": unit_bytes, "groups": groups,
            "unit_copy_s": per_unit[1:],
            "host_ptrs": [t.data_ptr() for t in tree_leaves(ws.host)]}


def fit_placement_link(walks: dict, latency_s: float) -> dict:
    """The host link of the slowest walk (``ring_walks``): the bandwidth
    with which ``latency_s`` plus one unit's bytes over it is that walk's
    copy time per unit, beside the rates of the slowest and the median
    walk."""
    slowest = max(walks["unit_copy_s"])
    nbytes = walks["unit_bytes"]
    return {"host_link_bw": nbytes / (slowest - latency_s),
            "host_link_latency_s": latency_s,
            "slowest_gb_s": nbytes / slowest / 1e9,
            "median_gb_s": nbytes / float(np.median(walks["unit_copy_s"]))
            / 1e9}


def placement_link(cfg: ModelConfig, interval: int, latency_s: float,
                   device: str = "cuda") -> dict:
    """An engine's weights (``engine_weights``) placed at ``interval`` as
    the engine places them (``place_weights``), and the link fitted from
    ``LINK_WALKS`` walks of the ring's copies out of that placement's
    pinned stack (``fit_placement_link``): an engine that adopts the
    placement and models this link streams from the very buffers it was
    calibrated on, at their slowest."""
    params = engine_weights(cfg, device)
    _, units = pattern_info(cfg)
    rt, placed = place_weights(build_model(cfg), params,
                               OffloadPlan(units, interval), device)
    walks = ring_walks(rt)
    return {"params": params, "runtime": rt, "placed": placed,
            "walks": walks, "walked_at": time.perf_counter(),
            "link": fit_placement_link(walks, latency_s)}


def walk_again(placement: dict, latency_s: float) -> dict:
    """A second set of ``LINK_WALKS`` ring walks out of ``placement``'s
    pinned stack, taken just before serving, and the link fitted from the
    slowest walk of both sets (``fit_placement_link``), which ``placement``
    then carries as its link. Returns each set's seconds per unit and its
    own fit, the seconds between the sets and the fit of both."""
    second = ring_walks(placement["runtime"])
    first = placement["walks"]
    both = dict(first, unit_copy_s=first["unit_copy_s"]
                + second["unit_copy_s"])
    placement["link"] = fit_placement_link(both, latency_s)
    return {"first_unit_copy_ms": [t * 1e3 for t in first["unit_copy_s"]],
            "second_unit_copy_ms": [t * 1e3 for t in second["unit_copy_s"]],
            "first": fit_placement_link(first, latency_s),
            "second": fit_placement_link(second, latency_s),
            "seconds_between_sets": time.perf_counter()
            - placement["walked_at"],
            "link": placement["link"]}


def relinked_records(cfg: ModelConfig, ecfg: EngineConfig,
                     measured: dict[tuple[str, int, int], MeasuredTimes],
                     hw: HardwareModel) -> dict[str, PerformanceRecord]:
    """The records ``measured_records`` built, rebuilt from the unit times
    they measured (its second value) with ``hw``'s host link: the link
    sets only the transfer term, so nothing is timed again."""
    batches, seqs = record_buckets(ecfg)
    out = {}
    for phase in ("prefill", "decode"):
        rec = PerformanceRecord(model_name=cfg.name, hardware=hw.name,
                                phase=phase, batches=sorted(batches),
                                seqs=sorted(seqs), measure="wallclock")
        for b in rec.batches:
            for s in rec.seqs:
                mt = measured[(phase, b, s)]
                times = _layer_times(dataclasses.replace(
                    mt, t_transfer_s=hw.transfer_time(mt.unit_bytes)))
                for slo in SLO_GRID:
                    rec.set(slo, b, s, optimal_interval(times, slo))
        out[phase] = rec
    return out


def measured_records(cfg: ModelConfig, ecfg: EngineConfig,
                     hw: HardwareModel, device: str = "cuda"
                     ) -> tuple[dict[str, PerformanceRecord],
                                dict[tuple[str, int, int], MeasuredTimes]]:
    """The prefill and decode records of ``ecfg``'s buckets, built with
    ``measure="wallclock"`` on ``device`` against ``hw``'s link (the
    calibrated preset), and what each bucket measured: ``(phase, batch,
    seq) -> MeasuredTimes``."""
    an = PerformanceAnalyzer(cfg, hw, measure="wallclock", device=device)
    batches, seqs = record_buckets(ecfg)
    records = {phase: an.generate_record(SLO_GRID, batches, seqs, phase)
               for phase in ("prefill", "decode")}
    return records, an.bucket_times


def measured_tpot_slo(rec_decode: PerformanceRecord, times_fn,
                      cfg: ModelConfig, ecfg: EngineConfig, batch: int = 8,
                      seq: int = MAX_SEQ, interval: int | None = None
                      ) -> float:
    """The smallest SLO of the grid that an engine of ``ecfg`` serving
    against ``rec_decode`` and modeling its clock with ``times_fn`` can
    certify for ``batch`` rows at ``seq``: the record must have an interval
    the HBM budget can hold for that bucket and every smaller one (measured
    unit times need not grow with the bucket, and admission looks up the
    smaller buckets too), and the modeled iteration at the largest such
    interval, with the whole host KV tier streaming, must fit (else the
    scheduler's own TPOT check holds the requests back). The budget must
    force offloading: the record's ``NO_OFFLOAD`` also marks an SLO that no
    interval meets. ``interval``: an engine held at that interval instead
    of the budget's ceiling."""
    max_i = interval or memory_interval(cfg, ecfg)
    if max_i >= NO_OFFLOAD:
        raise ValueError("the HBM budget holds every unit: no interval "
                         "ceiling to size the SLO against")
    buckets = [(b, s) for b in rec_decode.batches if b <= batch
               for s in rec_decode.seqs if s <= seq]
    modeled = iter_time_with_interval_kv(times_fn(batch, seq, "decode"),
                                         max_i, ecfg.host_kv_bytes)
    for slo in SLO_GRID:
        if slo >= modeled and all(rec_decode.lookup(slo, b, s) <= max_i
                                  for b, s in buckets):
            return slo
    raise ValueError(f"no SLO up to {SLO_GRID[-1]} s is feasible for batch "
                     f"{batch} at seq {seq} within interval {max_i}")


def measured_engine(records: dict[str, PerformanceRecord],
                    hw: HardwareModel, placement: dict,
                    device: str = "cuda", *,
                    rest_mem_eff: float | None = None) -> ServingEngine:
    """``smoke_engine``'s configuration, admitting and choosing intervals
    from ``records`` measured on the card (``measured_records``) and
    serving the weights of ``placement`` (``placement_link`` at
    ``memory_interval``) from that placement, whose link ``hw`` was fitted
    to. Its modeled clock (``times_fn``) is ``hw`` in model mode, the
    calibrated preset fitted in the same run as the records, with the rest
    term fitted apart when ``rest_mem_eff`` is given (``calibrated_clock``):
    the engine calls ``times_fn`` inside every iteration, and in wall-clock
    mode each call would time a unit on the card in the middle of serving;
    the reference, too, measures only in its offline stage."""
    cfg, ecfg = smoke_config()
    eng = ServingEngine("measured", build_model(cfg), hw,
                        records["prefill"], records["decode"],
                        calibrated_clock(cfg, hw, rest_mem_eff, device),
                        ecfg, device=device, params=placement["params"])
    eng.adopt_placement(placement["runtime"], placement["placed"])
    return eng


def baseline_intervals(cfg: ModelConfig, rec_decode: PerformanceRecord,
                       times: LayerTimes, slo_s: float
                       ) -> tuple[dict[str, int], FlexGenDecision]:
    """The paper's headline comparison at batch 8, seq 1024: Select-N's
    interval from the record; DeepSpeed ZeRO-Inference's (interval 1); and
    SLO-aware FlexGen's decision over the *datasheet* ``h100`` preset (its
    peak-FLOPs estimator) and the measured ``times``, mapped to the interval
    with the same offloaded bytes. Returns the intervals and FlexGen's
    decision."""
    batch, seq = BASELINE_BUCKET
    p, units = pattern_info(cfg)
    flops = sum(costs.layer_flops(cfg, batch, 1, seq, j) for j in range(p))
    flexgen = flexgen_decision(times, H100, slo_s, flops)
    return {"select_n": rec_decode.lookup(slo_s, batch, seq),
            "deepspeed": deepspeed_plan(units).interval,
            "flexgen": flexgen_equivalent_interval(times, flexgen)}, flexgen


def policy_decode(cfg: ModelConfig, params: dict, interval: int, *,
                  batch: int, seq: int, steps: int,
                  device: str = "cuda") -> dict:
    """``steps`` decode iterations of ``batch`` rows at ``seq`` through
    ``OffloadRuntime.paged_decode_step`` at ``interval`` (on a GPU as
    replays of its CUDA graph, as the engine runs it), after one warm-up,
    on a runtime placed for this plan alone (offloaded units in pinned host
    memory, the rest on the card). Returns the plan's weight bytes on each
    side, each step's stream time on a GPU (CUDA events, as the engine's
    ``decode_ms``; none on the CPU) and the last step's logits."""
    model = build_model(cfg)
    _, units = pattern_info(cfg)
    plan = OffloadPlan(units, interval)
    rt, placed = place_weights(model, params, plan, device)
    d = paged_decode_inputs(decode_pool(cfg, model.virtual_kv, batch, seq,
                                        device), batch, seq)
    tokens = torch.zeros((batch,), dtype=torch.int32, device=device)
    on_card = torch.device(device).type == "cuda"
    step = functools.partial(rt.paged_decode_step, placed)
    inputs = (tokens, d.pos, d.pool, d.block_tables, d.context_lens,
              d.write_frames, d.write_offsets)
    if on_card:                      # as the engine runs its step
        call = Graphed(step, inputs, [(rt._stream, "copies")]
                       if rt._stream is not None else []).replay
    else:
        call = lambda: step(*inputs)
    ms = []
    for _ in range(steps + 1):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        logits, _ = call()
        if on_card:
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    return {"interval": interval, "host_weight_bytes": rt.host_weight_bytes,
            "device_weight_bytes": plan.device_bytes(
                costs.unit_weight_bytes(cfg)),
            "prefetch_copies": rt.prefetch_copies, "stream_ms": ms[1:],
            "logits": logits.float().cpu()}


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


# the paged decode attention's two kernels (csrc/decode_attention.cu)
PAGED_DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
# the paged chunk-prefill attention's two (csrc/prefill_attention.cu)
PAGED_CHUNK_KERNELS = ("chunk_split_kernel", "chunk_combine_kernel")


def trace_summary(trace: dict, wall_us: float, top: int = 8) -> dict:
    """Device coverage of a Chrome trace exported by ``torch.profiler``."""
    kernels, copies = [], []
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for ev in trace.get("traceEvents", []):
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy"):
            continue
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        (kernels if cat == "kernel" else copies).append(span)
        if cat == "kernel":
            by_name[ev["name"]][0] += float(ev["dur"])
            by_name[ev["name"]][1] += 1
    busy = _union_us(kernels + copies)
    kernel_us = max(sum(t for t, _ in by_name.values()), 1e-9)
    decode_us, chunk_us = (sum(t for n, (t, _) in by_name.items()
                               if any(k in n for k in names))
                           for names in (PAGED_DECODE_KERNELS,
                                         PAGED_CHUNK_KERNELS))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "wall_ms": wall_us / 1e3,
        "kernel_ms": _union_us(kernels) / 1e3,
        "copy_ms": _union_us(copies) / 1e3,
        "busy_ms": busy / 1e3,
        # copy time hidden under kernels (inclusion-exclusion of the unions)
        "copy_kernel_overlap_ms": (_union_us(kernels) + _union_us(copies)
                                   - busy) / 1e3,
        "idle_share": max(0.0, 1.0 - busy / wall_us),
        "kernel_launches": len(kernels),
        "paged_decode_ms": decode_us / 1e3,
        "paged_decode_share_of_kernel_time": decode_us / kernel_us,
        "paged_chunk_ms": chunk_us / 1e3,
        "paged_chunk_share_of_kernel_time": chunk_us / kernel_us,
        "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c}
                        for n, (t, c) in ranked],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/profile_engine")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--incremental", action="store_true",
                      help="profile the incremental chunk-prefill steps")
    mode.add_argument("--disk", action="store_true",
                      help="profile the disk-pressure trace with the async "
                           "copy-stage data plane")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA device")
    out = Path(args.out)
    if args.incremental:
        summary = profile_incremental(out)
    elif args.disk:
        summary = profile_disk(out)
    else:
        summary = profile_decode(args.iters, out)
    print(json.dumps(summary))
    return summary


def _profile(eng, steps, out: Path, name: str) -> dict:
    """Trace ``steps()`` (engine steps ending in a synchronize) and sum up
    the window's device coverage."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = steps()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / name
    prof.export_chrome_trace(str(trace_path))
    summary = trace_summary(json.loads(trace_path.read_text()), wall_us)
    summary.update({"device": torch.cuda.get_device_name(0), "iters": n,
                    "interval": eng.interval,
                    "streamed_pages_peak": eng.streamed_pages_peak})
    return summary


def profile_decode(iters: int, out: Path) -> dict:
    eng = smoke_engine()
    for req in smoke_requests(eng.cfg.vocab_size, 64,
                              np.random.default_rng(0)):
        eng.submit(req)
    for _ in range(200):                      # warm-up: everyone decoding
        eng.step()
        if not eng.queue and eng._active_batch() == len(PROMPT_LENS):
            break
    eng.step()
    torch.cuda.synchronize()

    def steps():
        for _ in range(iters):
            eng.step()
        return iters

    summary = _profile(eng, steps, out, "decode_trace.json")
    summary.update({
        "batch": eng._active_batch(),
        "decode_ms_engine_median": float(np.median(eng.decode_ms[-iters:])),
    })
    return summary


def profile_incremental(out: Path) -> dict:
    eng = smoke_engine(prefill_chunk_tokens=256, incremental_prefill=True)
    vocab = eng.cfg.vocab_size
    # warm-up: two chunks and a few decode steps build every kernel
    warm = smoke_requests(vocab, 2, np.random.default_rng(2), (300, 40))
    eng.run(warm, submit_all=True)
    reqs = smoke_requests(vocab, 16, np.random.default_rng(1),
                          LONG_PROMPT_LENS)
    for r in reqs:
        r.rid += len(warm)                    # past the warm-up's rids
        eng.submit(r)
    n_chunks = len(eng.chunk_ms)
    torch.cuda.synchronize()

    def steps():                              # until every prompt is in
        n = 0
        while any(r.state in (State.QUEUED, State.PREFILLING) for r in reqs):
            eng.step()
            n += 1
        return n

    summary = _profile(eng, steps, out, "incremental_trace.json")
    chunk_ms = eng.chunk_ms[n_chunks:]
    summary.update({
        "chunks": len(chunk_ms),
        "prompt_tokens": sum(r.prompt_len for r in reqs),
        "chunk_pages_streamed": eng.chunk_pages_streamed,
        "chunk_ms_engine_median": float(np.median(chunk_ms)),
    })
    return summary


def profile_disk(out: Path) -> dict:
    warm = disk_engine(async_plane=True)      # builds every kernel
    serve_disk_trace(warm, *disk_requests(warm, np.random.default_rng(0)))
    eng = disk_engine(async_plane=True, params=warm.params)
    del warm
    first, later = disk_requests(eng, np.random.default_rng(0))
    torch.cuda.synchronize()
    result = {}

    def steps():
        result.update(serve_disk_trace(eng, first, later))
        return len(eng.trace.iterations)

    summary = _profile(eng, steps, out, "disk_trace.json")
    plane, foot = eng.data_plane, eng.trace.footer()
    summary.update({
        "finished": result["finished"],
        "preemptions": result["preemptions"],
        "disk_demotions": result["disk_demotions"],
        "disk_stagings": result["disk_stagings"],
        "prefetch_pages": result["prefetch_pages"],
        "disk_out_pages": eng.kv.disk_out_pages_total,
        "disk_in_pages": eng.kv.disk_in_pages_total,
        "staged_issued_pages": foot["staged_issued_pages_total"],
        "staged_completed_pages": foot["staged_completed_pages_total"],
        # wall seconds of the plane's copies: on the serving thread (a
        # device->host copy also waits for the kernels queued before it)
        # and on the background worker
        "blocking_copy_s": plane.blocking_copy_s,
        "background_copy_s": plane.background_copy_s,
        "decode_ms_engine_median": float(np.median(eng.decode_ms)),
    })
    return summary


if __name__ == "__main__":
    main()
