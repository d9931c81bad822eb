"""Where a decode iteration's, or an incremental chunk step's, time goes on
the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_engine \\
        [--iters 4] [--out chiprun_out/profile_engine]
    PYTHONPATH=src python -m repro_torch.launch.profile_engine --incremental

Serves the full-width qwen2.5-3b (random weights, seed 0) with the engine
configuration that ``chip_smoke.py`` also builds through ``smoke_engine``
(interval autotuning under a memory ceiling of interval 6 plus 40 KV pages,
a 128-page host KV tier, TPOT 20 ms), warms up until all 8 requests decode,
then traces ``--iters`` decode iterations with ``torch.profiler``. With
``--incremental`` the engine prefills in 256-token chunks through the paged
chunk-prefill kernel: after a short warm-up run it serves
``LONG_PROMPT_LENS`` and traces every step until each prompt is prefilled
(the chunk steps, each of which also carries the decode iteration). Prints
one JSON object: the window's wall time (host clock, synchronized), the
device time covered by kernels, by host<->device copies, by both at once
and by either, the resulting device idle share, the paged decode and chunk
attention kernels' time and share of kernel time, and the kernels that took
the most device time. The Chrome trace is written under ``--out``. Needs a
GPU.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import costs
from repro_torch.core.hardware import PRESETS
from repro_torch.core.interval import OffloadPlan
from repro_torch.launch.serve import build_engine
from repro_torch.models.transformer import pattern_info
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.request import Request, State

PROMPT_LENS = (512, 300, 128, 64, 480, 200, 33, 17)
# prompts that span several 256-token chunks, for incremental prefill
LONG_PROMPT_LENS = (1000, 760, 130, 40)
MAX_SEQ = 1024
PAGE_SIZE = 16
TPOT_SLO_S = 0.02


def smoke_engine(device: str = "cuda", *, prefill_chunk_tokens: int = 0,
                 incremental_prefill: bool = False):
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
    chunk-prefill kernel over pages that sit partly on the host tier."""
    cfg = get_config("qwen2.5-3b")
    _, units = pattern_info(cfg)
    page_bytes = PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(
        max_batch=8, max_seq=MAX_SEQ, page_size=PAGE_SIZE,
        hbm_budget_bytes=OffloadPlan(units, 6).device_bytes(
            costs.unit_weight_bytes(cfg)) + 40 * page_bytes,
        host_kv_bytes=128 * page_bytes, autotune=True,
        prefill_chunk_tokens=prefill_chunk_tokens,
        incremental_prefill=incremental_prefill)
    return build_engine("smoke", cfg, PRESETS["h100"], ecfg,
                        [0.002 * k for k in range(1, 120)], device=device)


def smoke_requests(vocab: int, max_new_tokens: int, rng: np.random.Generator,
                   prompt_lens: tuple[int, ...] = PROMPT_LENS
                   ) -> list[Request]:
    """One request per ``prompt_lens`` entry, random prompt tokens."""
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=max_new_tokens, ttft_slo_s=2.0,
                    tpot_slo_s=TPOT_SLO_S)
            for i, n in enumerate(prompt_lens)]


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
    ap.add_argument("--incremental", action="store_true",
                    help="profile the incremental chunk-prefill steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA device")
    out = Path(args.out)
    summary = (profile_incremental(out) if args.incremental
               else profile_decode(args.iters, out))
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


if __name__ == "__main__":
    main()
