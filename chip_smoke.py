"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card name and power limit (nvidia-smi); build every CUDA kernel from the
   sources in ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
   parallel).
2. Kernel checks at the serving path's shapes: each kernel against its plain
   PyTorch version on the same inputs (bf16 tolerance) over its edge cases,
   two launches of each kernel bitwise equal, each row of a batch-8 decode
   bitwise equal to its request alone, and chunk rows bitwise equal
   whichever chunk carries them; then each kernel timed with CUDA events
   beside its bound, its plain version and, for flash attention,
   ``scaled_dot_product_attention`` (for the chunk kernel, SDPA over the
   context gathered beforehand, as a reference point), and each kernel
   again as a replay of a CUDA graph holding its one launch.
3. Full-width qwen2.5-3b (random weights, seed 0) served by the port's
   engine, whose decode step is a CUDA graph (the captures are counted),
   with online interval autotuning and a host KV tier: every request
   finishes at a finite offloading interval, the trace audit is clean, the
   decode and flash kernels ran on the main path, offloaded weight units
   sat in pinned host memory and were prefetched on the side stream; then
   the bucketed-prefill bitwise contract on two prompts that share a 2-page
   prefix. The full-width prefill through the flash kernel is held against
   the same prefill through plain dense attention. Then the same engine
   with incremental chunked prefill (256-token chunks) serves prompts of up
   to 1000 tokens whose pages sit partly on the host tier: every request
   finishes, the chunk kernel ran, every prompt token was computed once,
   chunks streamed host pages, and the longest prompt's final-chunk logits
   agree with its one-shot prefill. Then the disk (NVMe) KV tier:
   ``profile_engine.disk_engine``'s pressure trace at full width, once with
   the synchronous copy-stage plane and once with the async one (one set of
   weights): parks retire to disk and resumes stage back, every pool ends
   empty, the decode and flash kernels ran, and the two runs give the same
   tokens bit for bit, the same modeled clock (or, where the async run's
   staged prefetch moved an NVMe charge, the reference's 2% bound with every
   SLO met) and conserved staged-page counters; then a park's pages through
   a file-backed disk pool and back, bit for bit.
   The async run's drains are split from the outside into the wait for
   the background worker, the device wait and the copies, and the
   worker's page copy is timed on its own with the serving thread idle,
   issuing eager decode steps and replaying the step's graph, for the
   plane's copy routine and the one it replaced.
4. The analyzer's wall-clock mode on the card (``profile_engine``):
   ``calibration_phase`` measures the per-unit decode and prefill times
   (graph replays) with their CVs beside the same units called eagerly,
   the pinned host link (one flat buffer) and the LM-head rest, fits
   ``H100_CALIBRATED`` from them, places the measured engine's weights at
   its interval and refits the host link from the slowest of ten walks of
   the weight ring's copies out of that pinned stack, and builds the smoke
   buckets' records with ``measure="wallclock"``
   (the flash and paged decode kernels must run while it does), held
   against the model-mode records of the preset this run fitted;
   ``measured_engine_phase`` serves the smoke requests from that same
   placement against those records at the smallest TPOT SLO the engine
   can certify from them and that preset, with the rest term fitted apart,
   as its clock (every request finishes, audit clean) and sets the modeled
   verdict beside the measured stream time and the record's stack times
   (Queue C 6's rule: every decode step within the certified SLO, that
   SLO within 15% of the record's own); ``baselines_phase``
   runs Select-N, DeepSpeed (interval 1) and FlexGen decode steps on the
   card with the same weights, beside the simulator's latency from the
   measured unit time and link.
5. The fleet (``fleet_phase``) at full width on this one card: a
   2-instance affinity fleet, a round-robin fleet, one big instance and a
   1 prefill + 1 decode disaggregated fleet serve one multi-tenant trace
   with the same tokens, then one request migrates across instances
   mid-decode with the tokens of a never-migrated engine; every audit
   clean.
6. The CUDA engine in lockstep with the same engine on the CPU (the
   kernels' plain versions) on a small model: at interval 2 with a host KV
   tier, once with one-shot prefills and once with incremental chunked
   prefill, and on the disk pressure trace with the async plane: equal
   iteration records, logits within the DualEngine tolerance.
7. The port's serve CLI on the reduced default config: one-shot, incremental
   chunked prefill, three KV tiers with the async data plane, a 2-instance
   fleet and a disaggregated fleet.
8. The MoE decoder (``moe_phase``): dbrx-132b at full width, its depth cut
   to 4 layers (host memory), served by the engine at interval 4 with one
   6.52 GB unit streamed per step: every request finishes with a clean
   audit through the flash and paged decode kernels (checked at this
   path's 48 / 8 heads against their plain versions), the graphed decode
   step, prefetch copies and one pinned unit; prefix KV bitwise across
   prompt lengths, prefill logits against plain attention, the decode
   graph's replay bitwise the eager step, one block's decode output
   against fp32. Then a reduced dbrx in lockstep with the CPU engine and
   the serve CLI's ``--arch dbrx-132b``. Its clock's compute terms and
   LM-head rest are fitted to dbrx's own unit times on the card
   (``calibrate_units``), its link to the slowest of twenty ring walks,
   ten at placement and ten just before serving (``walk_again``; the
   measured engine of phase 4 takes its second ten the same way).
9. gemma-2b at full width (head_dim 256, ``gemma_phase``) through the
   engine at the smoke settings: a one-shot run through the flash and
   decode kernels at D 256, a second run whose greedy tokens must be
   bitwise the first's, an incremental run through the chunk kernel at
   D 256, and the longest prompt's prefill against plain attention. The
   three kernels' D 256 instances are checked and timed in phase 2
   (``check_d256``) at gemma's shapes.
10. Every model family through the dense-cache grouped decode
   (``families_phase``): xlstm-125m, paligemma-3b (256 stub patches) and
   seamless-m4t-medium (1024 stub frames into the encoder) at full width
   and depth, and the reduced jamba, through ``OffloadRuntime.prefill`` /
   ``.decode_step`` with the decode step as one CUDA graph: prefill
   against plain attention, 16 steps each bitwise the eager grouped step
   and within 3e-2 / 6e-2 of ``Model.decode_step``; jamba's Mamba and
   attention blocks at full width (Mamba against fp32, its state across
   seq and decode).

Prints a JSON ``kernels`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when there is no GPU or any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# bf16 tolerance of the kernel checks (tests/test_kernels.py)
TOL = dict(rtol=2e-2, atol=2e-2)
# logit tolerance of the end-to-end checks (DualEngine,
# tests/differential/harness.py): bf16 weights and KV, different rounding
RTOL, ATOL = 5e-2, 1e-1
# relative L2 bound on full-width (36-layer) logits against plain attention
FULL_REL_L2 = 5e-2
# a MoE token whose top-k boundary is closer than this (relative gap of the
# router's k-th and (k+1)-th probabilities) may route through other experts
# in bf16 than in fp32: a routing tie (the bf16 tolerance)
ROUTE_TIE = 2e-2
# the share of a MoE lockstep's emissions that the two engines may route
# through different experts (each such emission is excused the tolerance)
MOE_ROUTED_APART = 0.25
# H100 SXM datasheet peaks used for the bounds
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
MAX_SEQ = 1024                  # the smoke engine's max_seq


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 25, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events), the
    L2 cache overwritten between calls when ``flush`` is given."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, flush: torch.Tensor | None = None) -> float:
    """``time_ms`` of ``fn`` captured into a CUDA graph and replayed (the
    launch the engine's graphed decode step makes of it)."""
    from repro_torch.core.graphs import Graphed

    return time_ms(Graphed(fn, ()).replay, flush=flush)


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: bad output {tuple(g.shape)}")
    if not torch.allclose(g, w, **TOL):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max |err| {(g - w).abs().max():.4g}")
    return float((g - w).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels at the serving path's shapes
# ---------------------------------------------------------------------------


def check_decode(flush: torch.Tensor) -> dict:
    from repro_torch.kernels import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    b, h, vh, d, page, layers = 8, 16, 2, 128, 16, 36
    nb = MAX_SEQ // page
    frames = 2 * b * nb + 1
    # the engine's 6-D pool: the kernel reads one layer's strided slice
    pool = torch.randn((frames, page, layers, 2, vh, d), generator=gen,
                       device=dev).to(torch.bfloat16)
    layer = 17
    kp, vp = pool[:, :, layer, 0], pool[:, :, layer, 1]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.randperm(frames - 1, generator=gen, device=dev)[:b * nb]
    bt = bt.reshape(b, nb).to(torch.int32)
    cl = torch.randint(1, nb * page + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    errs = []
    span = DA.PAGES_PER_SPLIT * page
    cases = {"main": (q, bt, cl, 0)}
    bt_pad = bt.clone()
    bt_pad[0, 2:] = 99_999          # out-of-range entries past the context
    bt_pad[1, 3:] = -3
    cases["padded_oob"] = (q, bt_pad, torch.tensor(
        [18, 33, 7, 17, 45, 0, 1, 16], dtype=torch.int32, device=dev), 0)
    cases["batch1"] = (q[:1], bt[:1], torch.tensor([17], dtype=torch.int32,
                                                   device=dev), 0)
    cases["window"] = (q, bt, cl, 100)
    # contexts at and around one split's span, one token and none
    edges = torch.tensor([span, span - 1, span + 1, 1, 0, nb * page,
                          3 * span + 5, 2 * span], dtype=torch.int32,
                         device=dev)
    cases["split_edges"] = (q, bt_pad, edges, 0)
    cases["window_in_split"] = (q, bt, edges, 40)
    cases["g1"] = (q[:, :vh], bt, cl, 0)
    cases["g4"] = (q[:, :4 * vh], bt, cl, 0)
    for name, (qq, tt, ll, win) in cases.items():
        got = DA.paged_decode_attention(qq, kp, vp, tt, ll, window=win)
        want = DA.paged_decode_attention_plain(qq, kp, vp, tt, ll, window=win)
        errs.append(max_err(got, want, f"paged_decode[{name}]"))
        zero_rows = (ll.clamp(0, nb * page) == 0).nonzero().flatten()
        if torch.count_nonzero(got[zero_rows]):
            raise AssertionError(f"paged_decode[{name}]: a cl = 0 row is "
                                 f"not all zeros")
    # the output bits repeat, and do not depend on the rest of the batch
    for win in (0, 100):
        first = DA.paged_decode_attention(q, kp, vp, bt, cl, window=win)
        if not torch.equal(first, DA.paged_decode_attention(
                q, kp, vp, bt, cl, window=win)):
            raise AssertionError("paged_decode: two launches differ")
        for i in range(b):
            alone = DA.paged_decode_attention(
                q[i:i + 1], kp, vp, bt[i:i + 1], cl[i:i + 1], window=win)
            if not torch.equal(alone[0], first[i]):
                raise AssertionError(f"paged_decode: row {i} alone differs "
                                     f"from its row in the batch")
    checks = list(cases) + ["bitwise_repeat", "batch_independent"]
    ms = time_ms(lambda: DA.paged_decode_attention(q, kp, vp, bt, cl),
                 flush=flush)
    in_graph_ms = graph_ms(lambda: DA.paged_decode_attention(q, kp, vp, bt,
                                                             cl), flush)
    plain_ms = time_ms(lambda: DA.paged_decode_attention_plain(
        q, kp, vp, bt, cl))
    tokens = int(cl.clamp(0, nb * page).sum())
    nbytes = (tokens * vh * d * 2 * 2          # K and V, bf16
              + 2 * b * h * d * 2              # q in, out
              + bt.numel() * 4 + cl.numel() * 4)
    flops = 4 * tokens * h * d                 # QK^T and PV
    bound_ms, bound_by = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                             (flops / BF16_FLOPS_S * 1e3, "operations"))
    log(f"paged_decode: B={b} H={h} V={vh} D={d} page={page} nb={nb} "
        f"splits={-(-nb // DA.PAGES_PER_SPLIT)} tokens={tokens} "
        f"checks={checks} max_abs_err={max(errs):.3g} "
        f"ms={ms:.4f} graph_ms={in_graph_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:71",
            "max_abs_err": max(errs), "ms": ms, "graph_ms": in_graph_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "check": "pass", "checks": checks}


def check_flash(flush: torch.Tensor) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    b, h, vh, s, d = 1, 16, 2, MAX_SEQ, 128
    # [B,S,H,D] projections viewed as [B,H,S,D], as the prefill passes them
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    k = torch.randn((b, s, vh, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    v = torch.randn((b, s, vh, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    errs = []
    # (q, k, v, keywords): the serving shape first; strided [B,S,H,D] views
    # throughout, ragged lengths, head_dim 16-64 as D-slices of the same
    cases = {"causal": (q, k, v, {}), "window": (q, k, v, {"window": 200}),
             "kv_len": (q, k, v, {"causal": False, "kv_len": 700}),
             "offset": (q[:, :, :77], k, v, {}),
             "pos_offset": (q[:, :, :77], k, v, {"pos_offset": -300}),
             "ragged": (q[:, :, :200], k[:, :, :200], v[:, :, :200], {}),
             "causal_kv_len": (q[:, :, :333], k, v, {"kv_len": 901,
                                                     "window": 150})}
    for dd in (16, 32, 64):
        cases[f"d{dd}"] = (q[:, :, :259, :dd], k[:, :, :259, :dd],
                           v[:, :, :259, :dd], {"window": 70})
    for name, (qq, kk, vv, kw) in cases.items():
        got = FA.flash_attention(qq, kk, vv, **kw)
        want = FA.flash_attention_plain(qq, kk, vv, **kw)
        errs.append(max_err(got, want, f"flash[{name}]"))
    if not torch.equal(FA.flash_attention(q, k, v), FA.flash_attention(q, k, v)):
        raise AssertionError("flash: two launches differ")
    checks = list(cases) + ["bitwise_repeat"]
    ms = time_ms(lambda: FA.flash_attention(q, k, v), flush=flush)
    in_graph_ms = graph_ms(lambda: FA.flash_attention(q, k, v), flush)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush=flush)
    pairs = s * (s + 1) // 2                   # causal (q, k) pairs
    flops = 4 * b * h * pairs * d
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    bound_ms, bound_by = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                             (flops / BF16_FLOPS_S * 1e3, "operations"))
    log(f"flash: B={b} H={h} V={vh} S={s} D={d} causal checks={checks} "
        f"max_abs_err={max(errs):.3g} "
        f"ms={ms:.4f} graph_ms={in_graph_ms:.4f} plain_ms={plain_ms:.4f} "
        f"sdpa_ms={lib_ms:.4f} (kernel / sdpa {ms / lib_ms:.3f}) "
        f"bound_ms={bound_ms:.5f}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": max(errs), "ms": ms, "graph_ms": in_graph_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "check": "pass", "checks": checks}


def check_chunk(flush: torch.Tensor) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import prefill_attention as PA

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    h, vh, d, page, layers, batch = 16, 2, 128, 16, 36, 8
    nb = MAX_SEQ // page
    frames = 2 * batch * nb + 1                 # the smoke engine's pool
    pool = torch.randn((frames, page, layers, 2, vh, d), generator=gen,
                       device=dev).to(torch.bfloat16)
    layer = 17
    kp, vp = pool[:, :, layer, 0], pool[:, :, layer, 1]
    q = torch.randn((256, h, d), generator=gen, device=dev).to(torch.bfloat16)
    q32 = torch.randn((64, 2 * h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    bt = torch.randperm(frames - 1, generator=gen, device=dev)[:nb].to(
        torch.int32)
    bt_pad = bt.clone()
    bt_pad[32:] = 99_999        # out-of-range entries past the context
    bt_pad[40:] = -3
    span = PA.SPAN_KEYS
    # (queries, k pages, v pages, table, start, context_len): the serving
    # chunk first; every case reads the strided layer slice of the pool
    cases = {"main": (q, kp, vp, bt, 768, 1024),
             "first_chunk": (q, kp, vp, bt, 0, 256),
             "partial_final": (q[:77], kp, vp, bt, 512, 589),
             "padded_oob": (q, kp, vp, bt_pad, 256, 512),
             "context_clamped": (q, kp, vp, bt, 700, 800),
             "context_zero": (q[:64], kp, vp, bt, 0, 0),
             "single_token": (q[:1], kp, vp, bt, 1000, 1001),
             # contexts across one and several span bounds
             "cross_one_span": (q[:64], kp, vp, bt, span - 30, span + 34),
             "cross_spans": (q, kp, vp, bt, 2 * span - 100, 3 * span + 156),
             # tiles straddling a bound: their first rows see no key of
             # the later span
             "later_span_empty": (q[:20], kp, vp, bt, span - 6, span + 14),
             # queries 990..1029 over a context of 1000: the last live
             # page (keys up to 1007) stays visible
             "context_below_chunk_end": (q[:40], kp, vp, bt, 990, 1000),
             "g1": (q[:, :vh], kp, vp, bt, 768, 1024),
             "g4": (q[:, :4 * vh], kp, vp, bt, 768, 1024),
             "g16": (q32, kp, vp, bt, 600, 664)}
    for dd in (16, 32, 64):     # head dims as D-slices of the same pool
        cases[f"d{dd}"] = (q[..., :dd], kp[..., :dd], vp[..., :dd], bt, 300,
                           556)
    errs = []
    for name, (qq, kk, vv, tt, st, cl) in cases.items():
        got = PA.paged_chunk_attention(qq, kk, vv, tt, st, cl)
        want = PA.paged_chunk_attention_plain(qq, kk, vv, tt, st, cl)
        errs.append(max_err(got, want, f"paged_chunk[{name}]"))
        if cl == 0 and torch.count_nonzero(got):
            raise AssertionError("paged_chunk[context_zero]: not all zeros")
    c, start, cl = 256, 768, 1024
    # the bits repeat, and a row's bits depend only on its position and the
    # keys up to it: tokens 800-815 in the serving chunk and in a 16-token
    # chunk over the same table, and single tokens alone
    full = PA.paged_chunk_attention(q, kp, vp, bt, start, cl)
    if not torch.equal(full, PA.paged_chunk_attention(q, kp, vp, bt, start,
                                                      cl)):
        raise AssertionError("paged_chunk: two launches differ")
    part = PA.paged_chunk_attention(q[32:48], kp, vp, bt, 800, 816)
    if not torch.equal(part, full[32:48]):
        raise AssertionError("paged_chunk: tokens 800-815 differ between a "
                             "256-token and a 16-token chunk")
    for t in (0, 7, 191, 255):
        alone = PA.paged_chunk_attention(q[t:t + 1], kp, vp, bt, start + t,
                                         start + t + 1)
        if not torch.equal(alone[0], full[t]):
            raise AssertionError(f"paged_chunk: token {start + t} alone "
                                 f"differs from its row in the chunk")
    # a one-span tile's direct write equals the combine of one non-empty
    # span: token 255 alone (one span) and in a chunk at start 250, context
    # 270, whose first tile has a second span with no key visible to it
    bound = PA.paged_chunk_attention(q[:20], kp, vp, bt, span - 6, span + 14)
    alone = PA.paged_chunk_attention(q[5:6], kp, vp, bt, span - 1, span)
    if not torch.equal(alone[0], bound[5]):
        raise AssertionError(f"paged_chunk: token {span - 1} alone differs "
                             f"from its row in a two-span tile")
    checks = list(cases) + ["bitwise_repeat", "chunk_independent",
                            "span_bound_direct_vs_combine"]
    splits = PA.split_geometry(c, h, vh, d, PA.key_end(c, page, start, cl))[0]
    ms = time_ms(lambda: PA.paged_chunk_attention(q, kp, vp, bt, start, cl),
                 flush=flush)
    in_graph_ms = graph_ms(lambda: PA.paged_chunk_attention(
        q, kp, vp, bt, start, cl), flush)
    plain_ms = time_ms(lambda: PA.paged_chunk_attention_plain(
        q, kp, vp, bt, start, cl))
    # a reference point only (not the library yardstick: no single PyTorch
    # call reads through a block table): SDPA over the context gathered
    # into contiguous K/V beforehand, bottom-right causal alignment
    import torch.nn.functional as F
    kg = kp[bt.long()].reshape(1, nb * page, vh, d).transpose(1, 2)
    vg = vp[bt.long()].reshape(1, nb * page, vh, d).transpose(1, 2)
    kg, vg = (x.repeat_interleave(h // vh, dim=1).contiguous()
              for x in (kg, vg))
    qg = q.transpose(0, 1)[None].contiguous()
    vis = (torch.arange(cl, device=dev)[None]
           <= start + torch.arange(c, device=dev)[:, None])
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=vis)
    sdpa_err = float((sdpa()[0].transpose(0, 1).float()
                      - full.float()).abs().max())
    sdpa_ms = time_ms(sdpa, flush=flush)
    live_keys = min(-(-cl // page) * page, start + c)
    pairs = sum(min(start + t + 1, live_keys) for t in range(c))
    flops = 4 * h * d * pairs                  # QK^T and PV, visible keys
    nbytes = (live_keys * vh * d * 2 * 2       # K and V, bf16, read once
              + 2 * c * h * d * 2              # q in, out
              + nb * 4)
    bound_ms, bound_by = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                             (flops / BF16_FLOPS_S * 1e3, "operations"))
    ptxas = [ln.strip() for ln in _build.build_log(
        "prefill_attention").splitlines() if "registers" in ln
        or "spill" in ln]
    log(f"paged_chunk: C={c} H={h} V={vh} D={d} page={page} nb={nb} "
        f"start={start} context_len={cl} splits={splits} (span {span} keys, "
        f"grid {-(-c // (64 // (h // vh)))} x {vh} x {splits}) "
        f"checks={checks} max_abs_err={max(errs):.3g} ms={ms:.5f} "
        f"graph_ms={in_graph_ms:.5f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
        f"sdpa_pregathered_ms={sdpa_ms:.5f} (max |diff| {sdpa_err:.3g}, "
        f"kernel / sdpa {ms / sdpa_ms:.3f})")
    log(f"paged_chunk ptxas: {' | '.join(ptxas)}")
    return {"name": "paged_chunk_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
            "replaces": "src/repro/kernels/prefill_attention.py:78",
            "max_abs_err": max(errs), "ms": ms, "graph_ms": in_graph_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "check": "pass", "checks": checks}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the bf16 tensor rate (ms, and which)."""
    return max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
               (flops / BF16_FLOPS_S * 1e3, "operations"))


def check_d256(flush: torch.Tensor) -> list[dict]:
    """The three kernels at head_dim 256, at gemma-2b's serving shapes (8
    query heads over 1 KV head, g 8): flash and chunk run their D 256
    instances (32-key tiles, Q in shared memory), decode its own. Each is
    held against its plain version over its edge cases and two launches
    bitwise, then timed as the other rows are; flash beside
    ``scaled_dot_product_attention`` (``enable_gqa``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(4)
    h, vh, d, page, layers, batch = 8, 1, 256, 16, 18, 8
    nb = MAX_SEQ // page
    bf = torch.bfloat16
    rows = []

    # flash: gemma's bucketed prefill of its longest prompt (512 tokens)
    s = 512
    q = torch.randn((1, s, h, d), generator=gen, device=dev).to(bf)
    k = torch.randn((1, s, vh, d), generator=gen, device=dev).to(bf)
    v = torch.randn((1, s, vh, d), generator=gen, device=dev).to(bf)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    enc = torch.randn((2, 1024, 16, d), generator=gen, device=dev).to(
        bf).transpose(1, 2)
    cases = {"causal": (q, k, v, {}), "window": (q, k, v, {"window": 100}),
             "kv_len": (q, k, v, {"causal": False, "kv_len": 333}),
             "ragged": (q[:, :, :77], k[:, :, :77], v[:, :, :77], {}),
             "pos_offset": (q[:, :, :40], k, v, {"pos_offset": -100}),
             # cross attention: 64 queries over 1024 keys, no mask
             "cross_sq_lt_sk": (enc[:, :, :64], enc, enc, {"causal": False})}
    errs = []
    for name, (qq, kk, vv, kw) in cases.items():
        errs.append(max_err(FA.flash_attention(qq, kk, vv, **kw),
                            FA.flash_attention_plain(qq, kk, vv, **kw),
                            f"flash_d256[{name}]"))
    if not torch.equal(FA.flash_attention(q, k, v), FA.flash_attention(q, k, v)):
        raise AssertionError("flash_d256: two launches differ")
    ms = time_ms(lambda: FA.flash_attention(q, k, v), flush=flush)
    pairs = s * (s + 1) // 2
    b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                       4 * h * pairs * d)
    rows.append({
        "name": "flash_attention_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "shape": f"B=1 H={h} V={vh} S={s} D={d} causal",
        "max_abs_err": max(errs), "ms": ms,
        "graph_ms": graph_ms(lambda: FA.flash_attention(q, k, v), flush),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush=flush),
        "check": "pass", "checks": list(cases) + ["bitwise_repeat"]})

    # decode and chunk read a layer slice of gemma's 6-D pool
    frames = 2 * batch * nb + 1
    pool = torch.randn((frames, page, layers, 2, vh, d), generator=gen,
                       device=dev).to(bf)
    kp, vp = pool[:, :, 9, 0], pool[:, :, 9, 1]
    qd = torch.randn((batch, h, d), generator=gen, device=dev).to(bf)
    bt = torch.randperm(frames - 1, generator=gen, device=dev)[
        :batch * nb].reshape(batch, nb).to(torch.int32)
    # the serving contexts: prompts of 17-512 tokens plus their decode
    cl = torch.tensor([527, 314, 141, 78, 495, 215, 48, 32],
                      dtype=torch.int32, device=dev)
    span = DA.PAGES_PER_SPLIT * page
    cases = {"main": (qd, bt, cl, 0), "window": (qd, bt, cl, 100),
             "split_edges": (qd, bt, torch.tensor(
                 [span, span - 1, span + 1, 1, 0, nb * page, 3 * span + 5,
                  2 * span], dtype=torch.int32, device=dev), 0)}
    errs = []
    for name, (qq, tt, ll, win) in cases.items():
        errs.append(max_err(
            DA.paged_decode_attention(qq, kp, vp, tt, ll, window=win),
            DA.paged_decode_attention_plain(qq, kp, vp, tt, ll, window=win),
            f"paged_decode_d256[{name}]"))
    if not torch.equal(DA.paged_decode_attention(qd, kp, vp, bt, cl),
                       DA.paged_decode_attention(qd, kp, vp, bt, cl)):
        raise AssertionError("paged_decode_d256: two launches differ")
    tokens = int(cl.sum())
    b_ms, b_by = bound(tokens * vh * d * 4 + 2 * batch * h * d * 2
                       + bt.numel() * 4 + cl.numel() * 4,
                       4 * tokens * h * d)
    call = lambda: DA.paged_decode_attention(qd, kp, vp, bt, cl)
    rows.append({
        "name": "paged_decode_attention_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:71",
        "shape": f"B={batch} H={h} V={vh} D={d} page={page} nb={nb} "
                 f"tokens={tokens}",
        "max_abs_err": max(errs), "ms": time_ms(call, flush=flush),
        "graph_ms": graph_ms(call, flush),
        "plain_ms": time_ms(lambda: DA.paged_decode_attention_plain(
            qd, kp, vp, bt, cl)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "check": "pass", "checks": list(cases) + ["bitwise_repeat"]})

    # chunk: the second 256-token chunk of the 512-token prompt
    qc = torch.randn((256, h, d), generator=gen, device=dev).to(bf)
    t1 = bt[0]
    cases = {"main": (qc, 256, 512), "first_chunk": (qc, 0, 256),
             "partial_final": (qc[:44], 256, 300),
             "cross_spans": (qc, 2 * PA.SPAN_KEYS - 100,
                             3 * PA.SPAN_KEYS + 156),
             "single_token": (qc[:1], 1000, 1001)}
    errs = []
    for name, (qq, st, ll) in cases.items():
        errs.append(max_err(
            PA.paged_chunk_attention(qq, kp, vp, t1, st, ll),
            PA.paged_chunk_attention_plain(qq, kp, vp, t1, st, ll),
            f"paged_chunk_d256[{name}]"))
    full = PA.paged_chunk_attention(qc, kp, vp, t1, 256, 512)
    if not torch.equal(full, PA.paged_chunk_attention(qc, kp, vp, t1, 256,
                                                      512)):
        raise AssertionError("paged_chunk_d256: two launches differ")
    alone = PA.paged_chunk_attention(qc[7:8], kp, vp, t1, 263, 264)
    if not torch.equal(alone[0], full[7]):
        raise AssertionError("paged_chunk_d256: token 263 alone differs "
                             "from its row in the chunk")
    c, start, cl1 = 256, 256, 512
    pairs = sum(start + t + 1 for t in range(c))
    b_ms, b_by = bound(cl1 * vh * d * 4 + 2 * c * h * d * 2 + nb * 4,
                       4 * h * d * pairs)
    call = lambda: PA.paged_chunk_attention(qc, kp, vp, t1, start, cl1)
    rows.append({
        "name": "paged_chunk_attention_d256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:78",
        "shape": f"C={c} H={h} V={vh} D={d} start={start} context={cl1}",
        "max_abs_err": max(errs), "ms": time_ms(call, flush=flush),
        "graph_ms": graph_ms(call, flush),
        "plain_ms": time_ms(lambda: PA.paged_chunk_attention_plain(
            qc, kp, vp, t1, start, cl1)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "check": "pass",
        "checks": list(cases) + ["bitwise_repeat", "chunk_independent"]})
    for r in rows:
        log(f"{r['name']}: {r['shape']} checks={r['checks']} "
            f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.5f} "
            f"graph_ms={r['graph_ms']:.5f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full-width engine
# ---------------------------------------------------------------------------


def replay_profile(replay, n: int = 3) -> dict:
    """``torch.profiler`` over ``n`` back-to-back replays of a graph: the
    device time its kernels and its copies cover, the copies' count and
    median duration, and the kernels that took the longest."""
    from repro_torch.launch.profile_engine import trace_summary

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "replay_trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    copies = [float(ev["dur"]) / 1e3 for ev in trace.get("traceEvents", [])
              if ev.get("ph") == "X" and ev.get("cat") == "gpu_memcpy"]
    summary = trace_summary(trace, wall_us, top=4)
    return {k: summary[k] for k in ("wall_ms", "kernel_ms", "copy_ms",
                                    "busy_ms", "idle_share",
                                    "top_kernels")} | {
        "copies": len(copies),
        "copy_ms_median": statistics.median(copies) if copies else None,
        "copy_ms_max": max(copies, default=None)}


def after_run_link(eng) -> dict:
    """Host-to-device copy rate of the engine's own placement after its
    run: three walks of each group's offloaded unit copied from the pinned
    stack as the weight ring copies it (``profile_engine.ring_walks``),
    beside the decode steps' stream-time spread and five back-to-back
    replays of the engine's decode graph with nothing between them (the
    last step's inputs; the pool's pages are free after the run)."""
    from repro_torch.launch.profile_engine import ring_walks

    rt, _ = eng._rt()
    out = {"decode_stream_ms_min": min(eng.decode_ms),
           "decode_stream_ms_max": max(eng.decode_ms)}
    if eng._decode_graph is not None:
        replay = eng._decode_graph[1].replay
        out["graph_replay_ms_isolated"] = time_ms(replay, iters=5)
        out["graph_replay_profile"] = replay_profile(replay)
    if rt._stream is None:
        return out
    walks = ring_walks(rt, walks=3)
    ms = [t * 1e3 for t in walks["unit_copy_s"]]
    out.update({"unit_bytes": walks["unit_bytes"], "unit_copy_ms": ms,
                "unit_copy_gb_s_median":
                walks["unit_bytes"] / statistics.median(ms) / 1e6})
    return out


def engine_phase() -> dict:
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.core.memory_manager import merge_stacked
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.launch.profile_engine import (PAGE_SIZE, TPOT_SLO_S,
                                                   smoke_engine,
                                                   smoke_requests)

    t0 = time.perf_counter()
    eng = smoke_engine()
    build_s = time.perf_counter() - t0
    cfg, page_size = eng.cfg, PAGE_SIZE
    rng = np.random.default_rng(0)
    reqs = smoke_requests(cfg.vocab_size, 16, rng)
    DA.launches = FA.launches = PA.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, submit_all=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    report = eng.trace.audit()
    intervals = sorted({it.interval for it in eng.trace.iterations})
    summary = {
        "finished": out["finished"], "rejected": out["rejected"],
        "tokens": out["tokens"], "slo_ok_modeled_clock": out["slo_ok"],
        "intervals": intervals, "final_interval": eng.interval,
        "host_weight_bytes": eng.host_weight_bytes,
        "prefetch_copies": eng.prefetch_copies,
        "decode_graph_captures": eng.decode_graph_captures,
        "interval_switches": eng.interval_switches,
        "launches": launches, "audit_ok": report.ok,
        "audit_checks": report.checks,
        "host_kv_peak_pages": eng.host_kv_peak_pages,
        "streamed_pages_peak": eng.streamed_pages_peak,
        "decode_iters": len(eng.decode_ms),
        # stream time per step (CUDA events), held against the TPOT SLO
        "decode_stream_ms_median": statistics.median(eng.decode_ms),
        "decode_steps_within_tpot_slo": sum(
            ms <= TPOT_SLO_S * 1e3
            for ms in eng.decode_ms) / len(eng.decode_ms),
        "prefill_stream_ms_median": statistics.median(eng.prefill_ms),
        "build_s": build_s, "run_s": run_s,
        "wall_modeled_s": out["wall_modeled_s"],
        "placement": after_run_link(eng),
    }
    log("engine: " + json.dumps(summary))
    if out["finished"] != len(reqs):
        raise AssertionError(f"engine finished {out['finished']} of "
                             f"{len(reqs)} requests")
    if not report.ok:
        raise AssertionError(f"trace audit: {report.violations[:5]}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    if not (eng.interval < NO_OFFLOAD and max(intervals) < NO_OFFLOAD):
        raise AssertionError(f"interval not finite: {intervals}")
    if eng.prefetch_copies <= 0 or eng.host_weight_bytes <= 0:
        raise AssertionError("no weight unit was offloaded and prefetched")
    if eng.streamed_pages_peak <= 0:
        raise AssertionError("no KV page streamed from the host tier")
    for r in eng.finished:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab() for t in r.generated):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.generated}")

    # bucketed-prefill bitwise contract: a shared 2-page prefix gets the
    # same KV bits whatever the prompt length it was computed under
    shared = rng.integers(0, cfg.vocab_size, 2 * page_size).astype(np.int32)
    a = np.concatenate([shared, rng.integers(0, cfg.vocab_size, 45)
                        .astype(np.int32)])
    b = np.concatenate([shared, rng.integers(0, cfg.vocab_size, 301)
                        .astype(np.int32)])
    rt, params = eng._rt()
    kv = []
    for p in (a, b):
        _, caches, _ = eng._bucketed_prefill(p, len(p))
        merged = merge_stacked(caches, rt.plan)
        kv.append([(m["self"]["k"][:, :, :2 * page_size],
                    m["self"]["v"][:, :, :2 * page_size]) for m in merged])
    same = all(torch.equal(x, y) for (ka, va), (kb, vb) in zip(*kv)
               for x, y in ((ka, kb), (va, vb)))
    log(f"prefix_kv_bitwise: {same} (prompts {len(a)} and {len(b)} tokens, "
        f"shared {2 * page_size}, interval {eng.interval})")
    if not same:
        raise AssertionError("prefix KV bits depend on the prompt length")

    # the full-width prefill through the flash kernel against the same
    # prefill through the plain dense attention, on the card. Rounding
    # differences in bf16 compound over 36 layers, so the bound is on the
    # relative L2 error of the logits (FULL_REL_L2), not elementwise
    toks = {"tokens": torch.as_tensor(b, device="cuda")[None]}
    got, _, _ = rt.prefill(params, toks, len(b))
    want, _, _ = rt.prefill(params, toks, len(b), attn_impl="reference")
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    log(f"prefill_vs_plain_attention: rel_l2 {rel:.4g} (bound "
        f"{FULL_REL_L2}), max_abs_err {float((got - want).abs().max()):.4g} "
        f"over {want.numel()} logits, argmax equal "
        f"{bool(got.argmax() == want.argmax())}")
    if not rel <= FULL_REL_L2:
        raise AssertionError("full-width prefill logits disagree with the "
                             "plain attention path")
    return launches


def incremental_phase() -> int:
    """The full-width engine with incremental chunked prefill: prompts of up
    to 1000 tokens in 256-token chunks through the paged chunk-prefill
    kernel, over pages that sit partly on the host tier. Returns the chunk
    kernel's launches on this path."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.launch.profile_engine import (LONG_PROMPT_LENS,
                                                   smoke_engine,
                                                   smoke_requests)

    eng = smoke_engine(prefill_chunk_tokens=256, incremental_prefill=True)
    cfg = eng.cfg
    reqs = smoke_requests(cfg.vocab_size, 16, np.random.default_rng(1),
                          LONG_PROMPT_LENS)
    first_logits: dict[int, np.ndarray] = {}
    greedy = eng._greedy

    def record(req, logits):
        # a request's first token comes from its final chunk's logits
        first_logits.setdefault(req.rid, logits.copy())
        return greedy(req, logits)

    eng._greedy = record
    DA.launches = FA.launches = PA.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, submit_all=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches,
                "paged_chunk_attention": PA.launches}
    report = eng.trace.audit()
    prompt_tokens = sum(r.prompt_len for r in reqs)
    summary = {
        "finished": out["finished"], "rejected": out["rejected"],
        "tokens": out["tokens"], "launches": launches,
        "chunks": len(eng.chunk_ms),
        "chunked_prefill_iters": out["chunked_prefill_iters"],
        "prefill_tokens_computed": eng.prefill_tokens_computed,
        "prompt_tokens": prompt_tokens,
        "chunk_pages_streamed": eng.chunk_pages_streamed,
        "host_kv_peak_pages": eng.host_kv_peak_pages,
        "intervals": sorted({it.interval for it in eng.trace.iterations}),
        "audit_ok": report.ok, "audit_checks": report.checks,
        # stream time of each chunk step (CUDA events)
        "chunk_stream_ms_median": statistics.median(eng.chunk_ms),
        "chunk_stream_ms_max": max(eng.chunk_ms),
        "decode_stream_ms_median": statistics.median(eng.decode_ms),
        "decode_graph_captures": eng.decode_graph_captures,
        "run_s": run_s, "wall_modeled_s": out["wall_modeled_s"],
    }
    log("incremental_engine: " + json.dumps(summary))
    if out["finished"] != len(reqs):
        raise AssertionError(f"incremental engine finished {out['finished']} "
                             f"of {len(reqs)} requests")
    if not report.ok:
        raise AssertionError(f"trace audit: {report.violations[:5]}")
    if PA.launches <= 0 or DA.launches <= 0:
        raise AssertionError(f"a kernel never ran on the path: {launches}")
    if eng.prefill_tokens_computed != prompt_tokens:
        raise AssertionError(
            f"prefill computed {eng.prefill_tokens_computed} tokens for "
            f"{prompt_tokens} prompt tokens: not linear")
    if eng.chunk_pages_streamed <= 0:
        raise AssertionError("no chunk streamed a host-tier page")

    # the longest prompt's final-chunk logits (read through the pool's bf16
    # prefix KV) against its one-shot bucketed prefill on the card
    longest = max(reqs, key=lambda r: r.prompt_len)
    want, _, _ = eng._bucketed_prefill(longest.prompt, longest.prompt_len)
    got = torch.as_tensor(first_logits[longest.rid])
    want = want[0].float().cpu()
    rel = float((got - want).norm() / want.norm())
    log(f"incremental_vs_one_shot: prompt {longest.prompt_len} tokens, "
        f"rel_l2 {rel:.4g} (bound {FULL_REL_L2}), argmax equal "
        f"{bool(got.argmax() == want.argmax())}, chunk stream ms median "
        f"{summary['chunk_stream_ms_median']:.3f} vs one-shot prefill "
        f"{eng.prefill_ms[-1]:.3f} ms")
    if not rel <= FULL_REL_L2:
        raise AssertionError("incremental chunk logits disagree with the "
                             "one-shot prefill")
    return PA.launches


def _page_bits(t: torch.Tensor) -> np.ndarray:
    """A copy of a page's bf16 bit patterns (no float conversion)."""
    return t.view(torch.int16).cpu().numpy().view(np.uint16).copy()


@contextlib.contextmanager
def drain_split(plane):
    """Time three parts of an async copy-stage plane's drains from the
    outside, leaving its counters and copies as they are: the waits for the
    background worker (``_wait_bg``), the device wait inside each
    device->host copy (a synchronize just before ``ops.copy_pages_to_host``,
    whose ``.cpu()`` would wait for the same kernels), and the copies
    themselves (``_exec_group`` less that device wait). Yields the dict the
    seconds accumulate in; ``drain_s`` is the drains' whole wall time, and
    ``worker_pages`` / ``worker_copy_s`` count the pages the background
    worker copied and the seconds its copy routine took for them."""
    import threading

    from repro_torch.kernels import ops

    split = {"drain_s": 0.0, "worker_wait_s": 0.0, "device_wait_s": 0.0,
             "copy_s": 0.0, "worker_pages": 0, "worker_copy_s": 0.0}
    inside = [False]
    drain, wait_bg, exec_group = plane.drain, plane._wait_bg, plane._exec_group
    to_disk = plane._host_to_disk
    to_host = ops.copy_pages_to_host

    def to_disk_split(srcs, dsts):
        t0 = time.perf_counter()
        to_disk(srcs, dsts)
        if threading.current_thread() is not threading.main_thread():
            split["worker_copy_s"] += time.perf_counter() - t0
            split["worker_pages"] += len(srcs)

    def timed(key, fn):
        def run(*args, **kwargs):
            if not inside[0]:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[key] += time.perf_counter() - t0
        return run

    def drain_split_run():
        inside[0] = True
        try:
            timed("drain_s", drain)()
        finally:
            inside[0] = False

    def to_host_split(*args, **kwargs):
        if inside[0]:
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            split["device_wait_s"] += time.perf_counter() - t0
        return to_host(*args, **kwargs)

    plane.drain = drain_split_run
    plane._wait_bg = timed("worker_wait_s", wait_bg)
    plane._exec_group = timed("copy_s", exec_group)
    plane._host_to_disk = to_disk_split
    ops.copy_pages_to_host = to_host_split
    try:
        yield split
    finally:
        del plane.drain, plane._wait_bg, plane._exec_group, plane._host_to_disk
        ops.copy_pages_to_host = to_host
        split["copy_s"] -= split["device_wait_s"]


def worker_copy_probe(eng, card: str) -> dict:
    """The background worker's host->disk page copy, timed on a thread of
    its own (24 one-page copies, the median of the last 20) with the
    serving thread idle, while it issues eager decode steps from Python
    (about 70 launches per layer, how the engine ran before its step was a
    CUDA graph) and while it replays the step's graph; each for the
    plane's routine (``numpy.copyto`` per page) and for the routine it
    replaced (``index_select`` + ``index_copy_``, through torch's intra-op
    pool, with a temporary per batch). Runs on ``eng``'s pools after its
    run, when every frame is free."""
    import functools
    import threading

    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    from repro_torch.core.graphs import Graphed

    plane = eng.data_plane
    ids = lambda f: torch.as_tensor(f, dtype=torch.long)

    def index_copy(srcs, dsts):
        plane.disk_pool.index_copy_(0, ids(dsts),
                                    plane.host_pool.index_select(0, ids(srcs)))

    rt, placed = eng._rt()
    step = functools.partial(rt.paged_decode_step, placed)
    d = paged_decode_inputs(decode_pool(eng.cfg, eng.model.virtual_kv, 4,
                                        eng.ecfg.max_seq, "cuda"), 4,
                            eng.ecfg.max_seq)
    inputs = (torch.zeros(4, dtype=torch.int32, device="cuda"), d.pos,
              d.pool, d.block_tables, d.context_lens, d.write_frames,
              d.write_offsets)
    graph = Graphed(step, inputs)

    def synced(call):
        def run():
            call()
            torch.cuda.synchronize()
        return run

    loads = {"idle": None, "eager_steps": synced(lambda: step(*inputs)),
             "graph_replays": synced(graph.replay)}
    n_host, n_disk = plane.host_pool.shape[0], plane.disk_pool.shape[0]
    out = {"page_bytes": eng.kv.page_bytes, "card": card}
    for name, routine in (("numpy_copyto", plane._host_to_disk),
                          ("index_copy", index_copy)):
        for load_name, load in loads.items():
            times: list[float] = []

            def worker():
                for k in range(24):
                    t0 = time.perf_counter()
                    routine([k % n_host], [k % n_disk])
                    times.append(time.perf_counter() - t0)

            th = threading.Thread(target=worker)
            th.start()
            steps = 0
            while load is not None and th.is_alive():
                load()
                steps += 1
            th.join()
            out[f"{name}_{load_name}_ms_per_page"] = (
                statistics.median(times[4:]) * 1e3)
            out[f"{name}_{load_name}_serving_steps"] = steps
    return out


def disk_phase(card: str) -> dict:
    """The disk (NVMe) KV tier at full width: the pressure trace of
    ``profile_engine.disk_engine`` with the sync and the async copy-stage
    plane, then a park's pages through a file-backed disk pool. Returns the
    decode and flash kernels' launches on the async run."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA
    from repro_torch.launch.profile_engine import (disk_engine, disk_requests,
                                                   serve_disk_trace)

    runs, launches, params = {}, {}, None
    for async_plane in (False, True):
        eng = disk_engine(async_plane=async_plane, params=params)
        params = eng.params
        first, later = disk_requests(eng, np.random.default_rng(0))
        DA.launches = FA.launches = PA.launches = 0
        t0 = time.perf_counter()
        with (drain_split(eng.data_plane) if async_plane
              else contextlib.nullcontext(None)) as split:
            out = serve_disk_trace(eng, first, later)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[async_plane] = {"paged_decode_attention": DA.launches,
                                 "flash_attention": FA.launches}
        report = eng.trace.audit()
        plane, foot = eng.data_plane, eng.trace.footer()
        summary = {
            "async": async_plane, "finished": out["finished"],
            "rejected": out["rejected"], "tokens": out["tokens"],
            "preemptions": out["preemptions"], "resumes": out["resumes"],
            "disk_demotions": out["disk_demotions"],
            "disk_stagings": out["disk_stagings"],
            "prefetch_pages": out["prefetch_pages"],
            "disk_direct_pages": out["disk_direct_pages"],
            "disk_out_pages": eng.kv.disk_out_pages_total,
            "disk_in_pages": eng.kv.disk_in_pages_total,
            "disk_kv_peak_pages": eng.disk_kv_peak_pages,
            "staged_issued_pages": foot["staged_issued_pages_total"],
            "staged_completed_pages": foot["staged_completed_pages_total"],
            "staged_inflight_pages": foot["staged_inflight_pages"],
            "launches": launches[async_plane], "audit_ok": report.ok,
            "audit_checks": report.checks, "slo_ok_modeled_clock":
                out["slo_ok"], "interval": eng.interval,
            "decode_stream_ms_median": statistics.median(eng.decode_ms),
            "prefill_stream_ms_median": statistics.median(eng.prefill_ms),
            "decode_graph_captures": eng.decode_graph_captures,
            # wall seconds of the plane's copies on the serving thread (a
            # device->host copy also waits for the kernels queued before
            # it) and on its background worker
            "blocking_copy_s": plane.blocking_copy_s,
            "background_copy_s": plane.background_copy_s,
            "run_s": run_s, "wall_modeled_s": out["wall_modeled_s"],
            "card": card,
        }
        if split is not None:
            summary["async_drain_split_s"] = split
            summary["worker_copy_ms_per_page_in_run"] = (
                split["worker_copy_s"] * 1e3 / max(split["worker_pages"], 1))
        log("disk_engine: " + json.dumps(summary))
        n = len(first) + len(later)
        if out["finished"] != n or out["rejected"]:
            raise AssertionError(f"disk engine finished {out['finished']} "
                                 f"of {n} requests")
        if not report.ok:
            raise AssertionError(f"trace audit: {report.violations[:5]}")
        eng.kv.check_invariants()
        if not (out["preemptions"] > 0 and out["disk_demotions"] > 0
                and out["disk_stagings"] > 0
                and eng.kv.disk_out_pages_total > 0):
            raise AssertionError("the disk trace did not park to disk and "
                                 "stage back")
        if (eng.kv.device.used_pages, eng.kv.host.used_pages,
                eng.kv.disk.used_pages) != (0, 0, 0):
            raise AssertionError("KV pages left in a pool after the run")
        if not all(v > 0 for v in launches[async_plane].values()):
            raise AssertionError(f"a kernel never ran on the disk path: "
                                 f"{launches[async_plane]}")
        for r in eng.finished:
            if len(r.generated) != r.max_new_tokens or not all(
                    0 <= t < eng.cfg.padded_vocab() for t in r.generated):
                raise AssertionError(f"rid {r.rid}: bad tokens")
        runs[async_plane] = eng
    sync, asyn = runs[False], runs[True]
    log("worker_copy_probe: " + json.dumps(worker_copy_probe(asyn, card)))
    log(f"disk_blocking_copy_s: sync {sync.data_plane.blocking_copy_s!r} "
        f"async {asyn.data_plane.blocking_copy_s!r} (async below sync "
        f"{asyn.data_plane.blocking_copy_s < sync.data_plane.blocking_copy_s})")
    # tests/differential/test_async_data_plane.py::_assert_equivalent
    tok_s = {r.rid: list(r.generated) for r in sync.finished}
    tok_a = {r.rid: list(r.generated) for r in asyn.finished}
    if tok_s != tok_a:
        raise AssertionError("sync and async runs emitted different tokens")
    d_clock = asyn.clock_s - sync.clock_s
    if asyn.prefetch_pages_total == 0:
        if d_clock != 0.0:
            raise AssertionError("the modeled clocks differ without a "
                                 "prefetch")
    else:
        # the staged prefetch moves NVMe reads to earlier iterations: the
        # clocks may differ within a hair, every SLO still met
        if abs(d_clock) > 0.02 * sync.clock_s:
            raise AssertionError(f"modeled clocks differ by {d_clock}")
        for eng in (sync, asyn):
            if not all(r.metrics()["tpot_ok"] and r.metrics()["ttft_ok"]
                       for r in eng.finished):
                raise AssertionError("an SLO missed on the modeled clock")
    foot = asyn.trace.footer()
    if not (foot["staged_issued_pages_total"]
            == foot["staged_completed_pages_total"] > 0
            and foot["staged_inflight_pages"] == 0):
        raise AssertionError(f"async staged pages not conserved: {foot}")
    if any(r.staged_issued_pages != r.staged_completed_pages
           for r in sync.trace.iterations):
        raise AssertionError("a sync iteration left a staged copy open")
    if (asyn.kv.disk_in_pages_total != sync.kv.disk_in_pages_total
            or asyn.kv.disk_out_pages_total != sync.kv.disk_out_pages_total):
        raise AssertionError("the async run moved different NVMe traffic")
    # test_async_disk_pressure_bitwise_and_clock_identical: the async plane
    # left copies in flight past an iteration's end, and prefetched
    deferred = sum(r.staged_issued_pages != r.staged_completed_pages
                   for r in asyn.trace.iterations)
    if not (deferred and asyn.prefetch_pages_total >= 1
            and sync.prefetch_pages_total == 0):
        raise AssertionError("the async run never deferred a copy or never "
                             "prefetched")
    log(f"disk_sync_vs_async: tokens bitwise equal over {len(tok_s)} "
        f"requests, modeled clock sync {sync.clock_s!r} async "
        f"{asyn.clock_s!r} (diff {d_clock!r}, prefetch pages "
        f"{asyn.prefetch_pages_total}), async staged issued == completed "
        f"== {foot['staged_issued_pages_total']}, iterations ending with "
        f"copies in flight {deferred}")

    # a park's pages through a file-backed disk pool and back, bit for bit
    # (tests/differential/test_disk_tier.py's physical gate): L1's two
    # host-tier pages retire to the file, its two device pages park on the
    # host and retire after them, and the resume stages all four back onto
    # the card and the host tier
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kv_disk.bin"
        eng = disk_engine(backing_path=str(path), params=params)
        first, _ = disk_requests(eng, np.random.default_rng(1))
        for r in first:
            eng.submit(r)
        eng.step()
        eng.step()
        s0, l1 = (r.rid for r in first)
        refs = eng.kv.refs(l1)
        before = [_page_bits(eng.pool[r.page] if r.tier == "device"
                             else eng.host_pool[r.page]) for r in refs]
        tiers = [r.tier for r in refs]
        eng.kv.demote_to_disk(l1, len(eng.kv.host_pages_of(l1)))
        if eng.kv.park(l1, [s0]) is None:
            raise AssertionError("park refused")
        eng.kv.demote_to_disk(l1, 99)
        if not all(r.tier == "disk" for r in eng.kv.refs(l1)):
            raise AssertionError("the parked pages did not all retire")
        frames = [r.page for r in eng.kv.refs(l1)]
        raw = np.fromfile(path, dtype=np.uint16).reshape(
            eng.kv.disk.total_pages, -1)
        on_file = all(np.array_equal(raw[f], b.ravel())
                      for f, b in zip(frames, before))
        eng.host_pool.zero_()                   # clobber the host tier
        if eng.kv.resume(l1) is None:
            raise AssertionError("resume refused")
        refs = eng.kv.refs(l1)
        tiers_back = [r.tier for r in refs]
        back = "disk" not in tiers_back and all(
            np.array_equal(_page_bits(eng.pool[r.page] if r.tier == "device"
                                      else eng.host_pool[r.page]), b)
            for r, b in zip(refs, before))
        eng.kv.check_invariants()
        log(f"disk_file_round_trip: {len(before)} pages (tiers {tiers} -> "
            f"disk file -> {tiers_back}, {eng.kv.page_bytes} B each, host "
            f"pool cleared before the resume), file holds "
            f"the parked bits {on_file}, resumed bits equal {back}, direct "
            f"disk->device pages {eng.kv.disk_direct_pages_total}, file "
            f"{path.stat().st_size} B")
        if not (on_file and back):
            raise AssertionError("page bits changed through the disk file")
    return launches[True]


# ---------------------------------------------------------------------------
# Phase 4: the analyzer's wall-clock mode, the measured engine, the baselines
# ---------------------------------------------------------------------------

# decode steps per policy in baselines_phase (after one warm-up)
BASELINE_STEPS = 10


def calibration_phase(card: str) -> dict:
    """The per-unit times, their CVs and the host link measured on the card,
    the ``H100_CALIBRATED`` values fitted from them beside the committed
    ones, then the wall-clock records of the smoke engine's buckets (the
    flash and paged decode kernels must run while they are built) against
    the model-mode records of the preset fitted in this run: cells that
    differ, and the worst relative error of the calibrated unit time
    against the measured one. Returns the calibration, that preset, the
    records and each bucket's times."""
    from repro_torch.core.analyzer import PerformanceAnalyzer
    from repro_torch.core.hardware import H100_CALIBRATED
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.profile_engine import (SLO_GRID, calibrate,
                                                   measured_records,
                                                   memory_interval,
                                                   placement_link,
                                                   smoke_config)

    cfg, ecfg = smoke_config()
    cal = calibrate(cfg)
    # the host link from the measured engine's own placement, the slowest
    # of several walks of the ring's copies out of its pinned stack (the
    # flat buffer's rate is logged beside it): records, clock and the
    # comparison below share this run's fit
    placement = placement_link(cfg, memory_interval(cfg, ecfg),
                               cal["link"]["latency_s"])
    link = placement["link"]
    hw = dataclasses.replace(H100_CALIBRATED, **{
        **cal["fitted"], "host_link_bw": link["host_link_bw"]})
    DA.launches = FA.launches = 0
    t0 = time.perf_counter()
    records, measured = measured_records(cfg, ecfg, hw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    model = PerformanceAnalyzer(cfg, hw, measure="model")
    cells, worst = {}, {}
    for phase, rec in records.items():
        ref = model.generate_record(SLO_GRID, rec.batches, rec.seqs, phase)
        pairs = [(a, b) for k in rec.table
                 for ra, rb in zip(rec.table[k], ref.table[k])
                 for a, b in zip(ra, rb)]
        cells[phase] = {"differ": sum(a != b for a, b in pairs),
                        "of": len(pairs)}
        errs = {f"{b}x{s}": model.measure_times(b, s, ph).t_compute_s
                / mt.t_compute_s - 1.0
                for (ph, b, s), mt in measured.items() if ph == phase}
        key = max(errs, key=lambda k: abs(errs[k]))
        worst[phase] = {"bucket": key, "rel_err": errs[key]}
    committed = {k: getattr(H100_CALIBRATED, k) for k in cal["fitted"]}
    summary = {
        "decode_unit": cal["decode"], "prefill_unit": cal["prefill"],
        "link": cal["link"], "fitted": cal["fitted"], "rest": cal["rest"],
        "flat_buffer_link_gb_s": cal["link"]["gb_s"],
        "placement_link": {
            **link, "interval": placement["runtime"].plan.interval,
            "walk_unit_copy_ms": [t * 1e3 for t in
                                  placement["walks"]["unit_copy_s"]]},
        "host_link_bw_used": hw.host_link_bw,
        "committed_h100_calibrated": committed,
        "record_build_s": build_s, "record_launches": launches,
        "record_cells_wallclock_vs_calibrated_model": cells,
        "worst_calibrated_unit_time_rel_err": worst,
        "decode_unit_ms_by_bucket": {
            f"{b}x{s}": mt.t_compute_s * 1e3
            for (ph, b, s), mt in measured.items() if ph == "decode"},
        "prefill_unit_ms_by_bucket": {
            f"{b}x{s}": mt.t_compute_s * 1e3
            for (ph, b, s), mt in measured.items() if ph == "prefill"},
        "card": card,
    }
    log("calibration: " + json.dumps(summary))
    for rec in records.values():
        if rec.measure != "wallclock" or rec.hardware != H100_CALIBRATED.name:
            raise AssertionError(f"{rec.phase} record: measure {rec.measure}, "
                                 f"hardware {rec.hardware}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"the wall-clock units did not run the CUDA "
                             f"kernels: {launches}")
    if not all(t.t_compute_s > 0 for t in measured.values()):
        raise AssertionError("a unit time is not positive")
    if not all(math.isfinite(v) and v > 0 for v in cal["fitted"].values()):
        raise AssertionError(f"bad fitted values: {cal['fitted']}")
    if not (math.isfinite(link["host_link_bw"]) and link["host_link_bw"] > 0):
        raise AssertionError(f"bad placement link: {link}")
    return {"cal": cal, "hw": hw, "records": records, "measured": measured,
            "placement": placement}


def measured_engine_phase(calibration: dict) -> dict:
    """The smoke engine's configuration against the wall-clock records:
    its TPOT SLO is the smallest grid SLO the engine can certify for batch
    8 at seq 1024 (``measured_tpot_slo``: the decode record has an interval
    within the smoke HBM budget there and in every smaller bucket, and the
    clock's iteration fits; the clock is the preset fitted in this run).
    Every request must finish with a clean audit. Prints the modeled verdict
    and decode-iteration time beside the measured stream time and the share
    of decode steps within the (8, 1024) bucket's own SLO in the record and
    within the engine's SLO. Returns the SLO and the engine's weights."""
    from repro_torch.core.interval import iter_time_with_interval_kv
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.profile_engine import (SLO_GRID,
                                                   calibrated_clock,
                                                   measured_engine,
                                                   measured_tpot_slo,
                                                   relinked_records,
                                                   smoke_config,
                                                   smoke_requests,
                                                   walk_again)

    cfg, ecfg = smoke_config()
    rest_eff = calibration["cal"]["rest"]["mem_eff"]
    placement = calibration.pop("placement")
    # a second set of ten walks just before serving: the link is refitted
    # from the slowest of all twenty, and the records rebuilt with it from
    # the unit times they measured (the baselines take the same)
    walk_sets = walk_again(placement, calibration["cal"]["link"]["latency_s"])
    calibration["hw"] = dataclasses.replace(
        calibration["hw"], host_link_bw=placement["link"]["host_link_bw"])
    calibration["records"] = records = relinked_records(
        cfg, ecfg, calibration["measured"], calibration["hw"])
    log("measured_engine_walk_sets: " + json.dumps(walk_sets))
    eng = measured_engine(records, calibration["hw"], placement,
                          rest_mem_eff=rest_eff)
    slo = measured_tpot_slo(records["decode"], eng.times_fn, cfg, ecfg)
    # the SLO the clock would certify with the preset's own rest term (the
    # layers' mem_eff applied to the LM head)
    preset_clock = calibrated_clock(cfg, calibration["hw"])
    slo_preset_rest = measured_tpot_slo(records["decode"], preset_clock, cfg,
                                        ecfg)
    rest_ms = {name: fn(8, MAX_SEQ, "decode").t_rest_s * 1e3
               for name, fn in (("fitted_apart", eng.times_fn),
                                ("preset", preset_clock))}
    # the (8, 1024) bucket's own smallest feasible SLO in the record alone,
    # beside the one the engine can certify
    max_i = eng._max_interval_now()
    slo_own = next(x for x in SLO_GRID
                   if records["decode"].lookup(x, 8, MAX_SEQ) <= max_i)
    modeled_bound = iter_time_with_interval_kv(
        eng.times_fn(8, MAX_SEQ, "decode"), max_i, ecfg.host_kv_bytes)
    reqs = smoke_requests(cfg.vocab_size, 16, np.random.default_rng(0),
                          tpot_slo_s=slo)
    DA.launches = FA.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, submit_all=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    report = eng.trace.audit()
    modeled = [it.dt_s * 1e3 for it in eng.trace.iterations
               if it.decode_batch > 0 and not it.admitted]
    # the record's (no-offload) stack times of the buckets the engine runs:
    # the one-shot prefill at (1, 1024) and full-batch decode at (8, 1024)
    units = eng.num_units
    stack_ms = {ph: (lambda mt: (mt.t_compute_s * units + mt.t_rest_s)
                     * 1e3)(calibration["measured"][(ph, b, MAX_SEQ)])
                for ph, b in (("prefill", 1), ("decode", 8))}
    summary = {
        "tpot_slo_s_8x1024_bucket_alone": slo_own,
        "decode_steps_within_8x1024_bucket_slo": sum(
            ms <= slo_own * 1e3 for ms in eng.decode_ms) / len(eng.decode_ms),
        "tpot_slo_s": slo,
        "decode_steps_within_tpot_slo": sum(
            ms <= slo * 1e3 for ms in eng.decode_ms) / len(eng.decode_ms),
        "certified_over_bucket_slo": slo / slo_own,
        "tpot_slo_s_with_the_presets_rest_term": slo_preset_rest,
        "modeled_rest_ms_8x1024": rest_ms,
        "modeled_iter_s_at_max_interval_host_tier_streaming": modeled_bound,
        "max_interval": max_i, "slo_ok_modeled_clock": out["slo_ok"],
        "modeled_decode_iter_ms_median": statistics.median(modeled),
        "decode_stream_ms_median": statistics.median(eng.decode_ms),
        "finished": out["finished"], "rejected": out["rejected"],
        "tokens": out["tokens"],
        "intervals": sorted({it.interval for it in eng.trace.iterations}),
        "decode_iters": len(eng.decode_ms),
        "decode_graph_captures": eng.decode_graph_captures,
        "record_decode_8x1024_stack_ms": stack_ms["decode"],
        "prefill_stream_ms_median": statistics.median(eng.prefill_ms),
        "record_prefill_1x1024_stack_ms": stack_ms["prefill"],
        "host_weight_bytes": eng.host_weight_bytes,
        "launches": launches, "audit_ok": report.ok,
        "audit_checks": report.checks, "run_s": run_s,
        "wall_modeled_s": out["wall_modeled_s"], "hardware": eng.hw.name,
        "record_measure": eng.rec["decode"].measure,
        "placement": after_run_link(eng),
        "calibration_link_gb_s": calibration["cal"]["link"]["gb_s"],
        "placement_link_gb_s_slowest": placement["link"]["slowest_gb_s"],
        "walk_set_gb_s_slowest": [walk_sets["first"]["slowest_gb_s"],
                                  walk_sets["second"]["slowest_gb_s"]],
        "walk_sets_seconds_apart": walk_sets["seconds_between_sets"],
        "placements_made": eng._placements,
        "served_from_timed_placement":
            eng._rt()[0] is placement["runtime"],
    }
    # Queue C 6's rule: every decode step within the certified SLO, and
    # that SLO within 15% of the (8, 1024) bucket's own record SLO
    summary["queue_c6_rule_met"] = (
        summary["decode_steps_within_tpot_slo"] == 1.0
        and summary["certified_over_bucket_slo"] <= 1.15)
    log("measured_engine: " + json.dumps(summary))
    if out["finished"] != len(reqs):
        raise AssertionError(f"measured engine finished {out['finished']} "
                             f"of {len(reqs)} requests")
    if not report.ok:
        raise AssertionError(f"trace audit: {report.violations[:5]}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never ran on the measured path: "
                             f"{launches}")
    for r in eng.finished:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab() for t in r.generated):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.generated}")
    return {"slo": slo, "params": eng.params}


def baselines_phase(calibration: dict, measured: dict) -> None:
    """The paper's headline comparison on the card at batch 8, seq 1024,
    with the measured engine's weights and TPOT SLO: Select-N (the wall-clock
    record's interval), DeepSpeed ZeRO-Inference (interval 1) and SLO-aware
    FlexGen (its decision over the datasheet preset, as the interval with
    the same offloaded bytes). Each runs ``BASELINE_STEPS`` decode steps on
    a runtime placed for its own plan; the simulator gets the measured unit
    time and link. The three policies compute the same logits."""
    from repro_torch.configs import get_config
    from repro_torch.core.interval import NO_OFFLOAD, LayerTimes
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.core.simulator import (schedule_for_interval,
                                            simulate_iteration)
    from repro_torch.launch.profile_engine import (baseline_intervals,
                                                   policy_decode)
    from repro_torch.models.transformer import pattern_info

    cal = calibration["cal"]
    cfg = get_config("qwen2.5-3b")
    _, units = pattern_info(cfg)
    slo = measured["slo"]
    link = cal["link"]
    t_unit = cal["decode"]["mean_s"]
    t_transfer = link["latency_s"] + link["bytes"] / link["bw_bytes_s"]
    times = LayerTimes(t_unit, t_transfer, units, link["bytes"],
                       t_rest_s=0.1 * t_unit)
    intervals, flexgen = baseline_intervals(
        cfg, calibration["records"]["decode"], times, slo)
    rows, logits = {}, {}
    for policy, interval in intervals.items():
        DA.launches = 0
        res = policy_decode(cfg, measured["params"], interval,
                            batch=8, seq=MAX_SEQ, steps=BASELINE_STEPS)
        logits[policy] = res.pop("logits")
        ms = statistics.median(res.pop("stream_ms"))
        # Select-N's schedule at the interval, each group's copy issued at
        # its own start (OffloadRuntime's walk) or one group earlier
        sim_ms, ahead_ms = (simulate_iteration(schedule_for_interval(
            [t_unit] * units, interval, t_transfer, 0.1 * t_unit,
            lookahead_groups=ahead))["latency_s"] * 1e3 for ahead in (1, 2))
        rows[policy] = {**res, "decode_launches": DA.launches,
                        "stream_ms_median": ms, "simulated_ms": sim_ms,
                        "measured_over_simulated": ms / sim_ms,
                        # each copy issued one group early: how far the
                        # host runs ahead of the card, bounded by the ring
                        "simulated_one_group_ahead_ms": ahead_ms,
                        "measured_over_one_group_ahead": ms / ahead_ms}
        if DA.launches != (BASELINE_STEPS + 1) * cfg.num_layers:
            raise AssertionError(f"{policy}: {DA.launches} decode launches")
        if (interval < NO_OFFLOAD) != (res["host_weight_bytes"] > 0):
            raise AssertionError(f"{policy}: interval {interval} with "
                                 f"{res['host_weight_bytes']} host bytes")
    log("baselines: " + json.dumps({
        "batch": 8, "seq": MAX_SEQ, "tpot_slo_s": slo,
        "t_unit_s": t_unit, "t_transfer_s": t_transfer,
        "flexgen": {"fraction": flexgen.fraction,
                    "est_iter_s": flexgen.est_iter_s},
        "policies": rows}))
    first = next(iter(logits.values()))
    for policy, lg in logits.items():
        if not (torch.isfinite(lg).all()
                and torch.allclose(lg, first, rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{policy}: logits differ from the other "
                                 f"policies'")
    log("baselines_logits: bitwise equal across policies "
        f"{all(torch.equal(lg, first) for lg in logits.values())}")


# ---------------------------------------------------------------------------
# Phase 5: the fleet, peer migration and disaggregated roles
# ---------------------------------------------------------------------------

FLEET_MAX_SEQ, FLEET_PAGE = 96, 16       # tests/test_fleet.py's geometry


def fleet_phase(card: str) -> dict:
    """``tests/test_fleet.py`` and ``tests/differential/test_disagg.py`` at
    qwen2.5-3b's full width, every instance on this one card (one set of
    weights; the peer link stays modeled, ``fleet.DEFAULT_PEER_LINK``): a
    2-instance affinity fleet, a round-robin fleet, one big instance
    (``max_batch`` 8 against 4) and a 1 prefill + 1 decode disaggregated
    fleet serve the same multi-tenant trace; then one request migrates
    across instances mid-decode. Fleets of the instance shape must agree
    bit for bit; the big instance's tokens where they differ must start
    differing at a numeric tie (the DualEngine rule). Every audit clean, at
    least one migration and one handoff. Returns the decode and flash
    kernels' launches on the fleet path."""
    from repro_torch.configs import get_config
    from repro_torch.core import costs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan
    from repro_torch.data.workload import (SLOClass, WorkloadConfig,
                                           generate_workload)
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_engine import SLO_GRID
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_map
    from repro_torch.models.transformer import pattern_info
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.fleet import Fleet
    from repro_torch.serving.request import Request, State

    cfg = get_config("qwen2.5-3b")
    _, units = pattern_info(cfg)
    page_bytes = FLEET_PAGE * costs.kv_cache_bytes(cfg, 1, 1)
    weights = OffloadPlan(units, NO_OFFLOAD).device_bytes(
        costs.unit_weight_bytes(cfg))
    params = tree_map(lambda t: t.cpu().pin_memory(), build_model(cfg).init(
        torch.Generator("cuda").manual_seed(0), "cuda"))
    logits: dict[str, dict[int, list]] = {}

    def instance(name, scale=1, role="mixed", dedup=True, extra=6):
        ecfg = EngineConfig(
            max_batch=4 * scale, max_seq=FLEET_MAX_SEQ, page_size=FLEET_PAGE,
            hbm_budget_bytes=weights + scale * extra * page_bytes,
            host_kv_bytes=scale * 40 * page_bytes, prefix_dedup=dedup,
            preemption=True, host_prefix_cache_pages=scale * 10 * dedup,
            disk_latency_s=1e-7, role=role, peer_latency_s=1e-7)
        eng = build_engine(name, cfg, PRESETS["h100"], ecfg, SLO_GRID,
                           params=params)
        if name not in ("aff0", "aff1", "big"):
            return eng
        seen = logits.setdefault(name, {})
        greedy = eng._greedy

        def record(req, lg):
            seen.setdefault(req.rid, []).append(lg.copy())
            return greedy(req, lg)

        eng._greedy = record
        return eng

    wcfg = WorkloadConfig(
        seed=7, process="poisson", rate_per_s=3000.0, mean_rounds=2.0,
        mean_think_s=0.0005, tenants=2, system_prompt_len=48,
        median_turn_len=12, turn_len_sigma=0.3, max_prompt_len=80,
        mean_output_len=6.0, max_output_len=10, vocab_size=128,
        slo_classes=(SLOClass("standard", 4.0, 0.05, weight=1.0),))
    reqs = generate_workload(wcfg, 20)

    def clone():
        return [Request(rid=r.rid, prompt=r.prompt.copy(),
                        max_new_tokens=r.max_new_tokens,
                        ttft_slo_s=r.ttft_slo_s, tpot_slo_s=r.tpot_slo_s,
                        arrival_s=r.arrival_s, tenant=r.tenant) for r in reqs]

    def tokens(engines):
        return {r.rid: tuple(r.generated) for e in engines
                for r in e.finished}

    DA.launches = FA.launches = 0
    t0 = time.perf_counter()
    runs, toks, by_rid = {}, {}, {}
    layouts = {"affinity": [("aff0", "mixed"), ("aff1", "mixed")],
               "round_robin": [("rr0", "mixed"), ("rr1", "mixed")],
               "disagg": [("p0", "prefill"), ("d0", "decode")]}
    for name, layout in layouts.items():
        engines = [instance(n, role=r, dedup=name != "disagg",
                            extra=8 if name == "disagg" else 6)
                   for n, r in layout]
        fleet = Fleet(engines, policy="round_robin" if name == "round_robin"
                      else "affinity")
        out = fleet.run(clone(), max_iters=50_000)
        ok, violations = fleet.audit()
        done = out["per_request"]
        runs[name] = {
            "finished": out["finished"], "rejected": out["rejected"],
            "tokens": out["tokens"], "slo_ok_modeled_clock": out["slo_ok"],
            "slo_attainment": sum(m["ttft_ok"] and m["tpot_ok"]
                                  for m in done) / max(len(done), 1),
            "migrations": out["migrations"], "handoffs": out["handoffs"],
            "handoff_bytes": out["handoff_bytes"],
            "reroutes": out["reroutes"], "audit_ok": ok,
            "audit_violations": violations[:5],
            "decode_stream_ms_median": statistics.median(
                [ms for e in engines for ms in e.decode_ms] or [math.nan]),
            "decode_graph_captures": {e.name: e.decode_graph_captures
                                      for e in engines},
            "per_instance_finished": {e.name: len(e.finished)
                                      for e in engines},
            "wall_modeled_s": out["wall_modeled_s"]}
        toks[name] = tokens(engines)
        by_rid[name] = {rid: lg for e in engines
                        for rid, lg in logits.get(e.name, {}).items()}
        if not ok:
            raise AssertionError(f"fleet {name}: audit {violations[:5]}")
        del fleet, engines
    big = instance("big", scale=2)
    out = big.run(clone(), max_iters=50_000)
    runs["big_instance"] = {
        "finished": out["finished"], "slo_ok_modeled_clock": out["slo_ok"],
        "audit_ok": big.trace.audit().ok,
        "decode_graph_captures": big.decode_graph_captures}
    toks["big_instance"] = tokens([big])
    by_rid["big_instance"] = logits["big"]
    del big

    # one forced migration (tests/test_fleet.py's scenario): a victim
    # decodes on m0, parks, a waiter keeps m0 overloaded, the fleet moves
    # the victim to m1; its tokens against a never-migrated engine
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 128, 40).astype(np.int32)
    alone = instance("alone")
    ref = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12,
                  ttft_slo_s=5.0, tpot_slo_s=1.0)
    alone.run([ref], max_iters=200)
    del alone
    e0, e1 = instance("m0"), instance("m1")
    fleet = Fleet([e0, e1], policy="affinity")
    victim = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12,
                     ttft_slo_s=5.0, tpot_slo_s=1.0)
    e0.submit(victim)
    for _ in range(5):
        e0.step()
    slot = victim.slot
    moves = e0.kv.park(victim.rid)
    ops.copy_pages_to_host(e0.pool, [m.src_page for m in moves],
                           e0.host_pool, [m.dst_page for m in moves])
    victim.state, victim.parked_at_s = State.PREEMPTED, e0.clock_s
    victim.preempt_count += 1
    e0.trace.event("park", victim.rid, e0.clock_s, slot=slot)
    victim.next_token = int(e0.tokens[slot])
    victim.resume_pos = int(e0.pos[slot])
    victim.slot = -1
    e0.active[slot] = False
    e0.slot_req[slot] = None
    e0.scheduler.preempted.append(victim)
    e0.submit(Request(rid=1, prompt=rng.integers(0, 128, 16).astype(np.int32),
                      max_new_tokens=4, ttft_slo_s=5.0, tpot_slo_s=1.0,
                      arrival_s=e0.clock_s))
    fleet._maybe_migrate(e0)
    fleet.run([], max_iters=5_000)
    ok, violations = fleet.audit()
    runs["migration"] = {
        "migrations": fleet.migrations, "audit_ok": ok,
        "victim_finished_on": next(e.name for e in (e0, e1) if any(
            r is victim for r in e.finished)),
        "victim_tokens_equal_never_migrated":
            tuple(victim.generated) == tuple(ref.generated)}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    del fleet, e0, e1

    # tokens: equal-shape fleets bit for bit; the big instance bit for bit
    # or, per request, first differing at a tie of the affinity fleet's
    # logits (and of the big instance's)
    equal_shape = toks["affinity"] == toks["round_robin"] == toks["disagg"]
    ties, beyond = 0, []
    for rid, want in toks["affinity"].items():
        got = toks["big_instance"].get(rid)
        if got == want:
            continue
        k = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        la, lb = by_rid["affinity"][rid][k], by_rid["big_instance"][rid][k]
        tie_a = ATOL + RTOL * abs(float(la[want[k]]))
        if (la[want[k]] - la[got[k]] <= tie_a
                and lb[got[k]] - lb[want[k]] <= tie_a):
            ties += 1
        else:
            beyond.append(rid)
    summary = {
        "card": card, "run_s": run_s, "launches": launches, "runs": runs,
        "tokens_bitwise_equal_shape_fleets": equal_shape,
        "tokens_bitwise_big_instance": toks["big_instance"]
        == toks["affinity"],
        "big_instance_requests_at_a_tie": ties,
        "per_request_tokens": {rid: list(t) for rid, t
                               in sorted(toks["affinity"].items())}}
    log("fleet: " + json.dumps(summary))
    mig = runs["migration"]
    if not (len(mig["migrations"]) == 1 and mig["audit_ok"]
            and mig["victim_finished_on"] == "m1"
            and mig["victim_tokens_equal_never_migrated"]):
        raise AssertionError(f"forced migration: {mig}")
    if runs["disagg"]["handoffs"] < 1:
        raise AssertionError("the disaggregated fleet handed nothing off")
    for name, r in runs.items():
        if name != "migration" and r["finished"] != len(reqs):
            raise AssertionError(f"{name}: {r['finished']} of {len(reqs)}")
        if not r["audit_ok"]:
            raise AssertionError(f"{name}: audit failed")
    if not equal_shape or beyond:
        raise AssertionError(f"fleet tokens differ: equal-shape fleets "
                             f"{equal_shape}, big instance beyond a tie "
                             f"for rids {beyond}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never ran on the fleet path: "
                             f"{launches}")
    return launches


def reference_phase(name: str = "reference_lockstep",
                    incremental: bool = False, disk: bool = False,
                    arch: str = "qwen2.5-3b") -> None:
    """The CUDA engine against the same engine on the CPU, which runs the
    kernels' plain versions: a small model, the same weights and the same
    trace, step by step. Scheduling decisions and iteration records must be
    equal, logits agree at the DualEngine tolerance, and on a numeric tie
    the CUDA engine is teacher-forced with the CPU engine's token. With
    ``incremental``, prompts prefill in 16-token chunks through the chunk
    kernel and some of those chunks read host-tier pages. With ``disk``,
    the engines are ``profile_engine.disk_engine``'s at the small width,
    with the async copy-stage plane, serving its disk pressure trace. With
    ``arch="dbrx-132b"``, the reduced MoE decoder (4 experts, top-2) at
    dbrx's group size (g 6), the expert sets of every MoE call recorded on
    both engines: an emission whose tokens went through other experts on
    the card than on the CPU (other GEMM orders round the hidden state
    otherwise, and a token near a routing tie then flips) may leave the
    tolerance, and at most ``MOE_ROUTED_APART`` of the emissions may be
    routed apart; every other emission is held to it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import costs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.launch.profile_engine import disk_engine, disk_requests
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request

    if arch == "qwen2.5-3b":
        cfg = reduce_config(get_config(arch), d_model=256, heads=4,
                            layers=8, d_ff=512, vocab=1024)
    else:
        cfg = reduce_config(get_config(arch), d_model=384, heads=12,
                            layers=8, d_ff=512, vocab=1024)
    _, units = pattern_info(cfg)
    page_bytes = 16 * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(max_batch=4, max_seq=64, page_size=16,
                        hbm_budget_bytes=OffloadPlan(units, 2).device_bytes(
                            costs.unit_weight_bytes(cfg)) + 6 * page_bytes,
                        host_kv_bytes=32 * page_bytes,
                        prefill_chunk_tokens=16 if incremental else 0,
                        incremental_prefill=incremental)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    later: list[tuple] = []           # (engine, its second-wave requests)
    if disk:
        cpu, gpu = (disk_engine(d, async_plane=True, params=params, cfg=cfg)
                    for d in ("cpu", "cuda"))
        for eng in (gpu, cpu):
            first, wave = disk_requests(eng, np.random.default_rng(5))
            later.append((eng, wave))
            creqs = {r.rid: r for r in first + wave}
            for r in first:
                eng.submit(r)
        prompts = list(creqs)
    else:
        slos = [0.002 * k for k in range(1, 30)]
        cpu, gpu = (build_engine(f"ref-{d}", cfg, PRESETS["h100"], ecfg,
                                 slos, device=d, params=params)
                    for d in ("cpu", "cuda"))
        for eng in (cpu, gpu):
            if not eng.set_interval(2):
                raise AssertionError("interval 2 refused")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (20, 9, 30, 14, 25, 5)]
        for eng in (gpu, cpu):
            creqs = {i: Request(rid=i, prompt=p, max_new_tokens=10,
                                ttft_slo_s=10.0, tpot_slo_s=10.0)
                     for i, p in enumerate(prompts)}
            for r in creqs.values():
                eng.submit(r)
    # route_apart: emissions whose tokens the two engines routed through
    # different experts, route_ties: those of them whose logits left the
    # tolerance or whose token differs
    state = {"expect": {}, "compares": 0, "ties": 0, "err": 0.0,
             "route_apart": 0, "route_ties": 0}
    # the expert sets ([B, S, k], ids ascending) of each engine's eager MoE
    # calls in this step, and of the calls the CUDA engine's decode graph
    # captured (a replay runs no Python but refreshes these tensors); the
    # CPU engine's sets of each rid's emissions in this step
    moe_calls = cfg.num_layers if cfg.moe is not None else 0
    routes: dict[str, list] = {"cpu": [], "cuda": []}
    captured: list = []
    cpu_sets: dict[int, list] = {}

    def watched(c, p, x):
        probs, top_p, top_i = route(c, p, x)
        ids = top_i.sort(dim=-1).values
        if torch.cuda.is_current_stream_capturing():
            captured.append(ids)
        else:
            routes[x.device.type].append(ids)
        return probs, top_p, top_i

    def emission_sets(calls, req, slot, prefill: bool) -> torch.Tensor:
        """The expert sets of one emission's tokens over one forward's MoE
        calls: the prompt of a prefill, the request's row of a decode."""
        if prefill:
            return torch.stack([c[0, :req.prompt_len].cpu() for c in calls])
        return torch.stack([c[slot, 0].cpu() for c in calls])

    def note_cpu_routes(grown: list[int]) -> None:
        """The CPU step's prefills (in ``prefill_log`` order), then its
        decode: each forward made ``moe_calls`` MoE calls."""
        cpu_sets.clear()
        calls = routes["cpu"]
        for i, (req, slot, _lg) in enumerate(cpu.prefill_log):
            cpu_sets.setdefault(req.rid, []).append(emission_sets(
                calls[i * moe_calls:(i + 1) * moe_calls], req, slot, True))
        if cpu.last_decode is not None:
            i = len(cpu.prefill_log)
            dec = calls[i * moe_calls:(i + 1) * moe_calls]
            for slot in np.flatnonzero(cpu.last_decode["active"]):
                rid = next(r for r in grown if creqs[r].slot == slot)
                cpu_sets.setdefault(rid, []).append(
                    emission_sets(dec, creqs[rid], slot, False))

    def routed_apart(req, logits) -> bool:
        """Whether the CUDA engine routed this emission's tokens through
        other experts than the CPU engine: its last eager forward for a
        prefill, the decode graph's captured calls for a decode step."""
        want = cpu_sets[req.rid].pop(0)
        prefill = bool(gpu.prefill_log) and gpu.prefill_log[-1][2] is logits
        calls = routes["cuda"][-moe_calls:] if prefill \
            else captured[-moe_calls:]
        return not torch.equal(
            emission_sets(calls, req, req.slot, prefill), want)

    def forced(req, logits):
        want = state["expect"][req.rid].pop(0)
        close = np.allclose(logits, want, rtol=RTOL, atol=ATOL)
        if moe_calls and routed_apart(req, logits):
            state["route_apart"] += 1
            if not close or np.argmax(logits) != np.argmax(want):
                # the two engines routed this emission's tokens through
                # different experts
                state["compares"] += 1
                state["route_ties"] += 1
                return int(np.argmax(want))
        state["err"] = max(state["err"], float(np.abs(logits - want).max()))
        if not close:
            raise AssertionError(f"rid {req.rid}: CUDA logits disagree")
        got, tok = int(np.argmax(logits)), int(np.argmax(want))
        state["compares"] += 1
        if got != tok:
            tie = ATOL + RTOL * abs(float(want[tok]))
            if not (want[tok] - want[got] <= tie
                    and logits[got] - logits[tok] <= tie):
                raise AssertionError(f"rid {req.rid}: token beyond a tie")
            state["ties"] += 1
        return tok

    gpu._greedy = forced
    route = L.route
    if moe_calls:
        L.route = watched
    try:
        for it in range(300):
            if it == 2:                     # the disk trace's second wave
                for eng, wave in later:
                    for r in wave:
                        eng.submit(r)
            if not (cpu.scheduler.has_work() or cpu._active_batch()):
                break
            before = {rid: len(r.generated) for rid, r in creqs.items()}
            routes["cpu"].clear()
            routes["cuda"].clear()
            cpu.step()
            grown = [rid for rid, r in creqs.items()
                     if len(r.generated) > before[rid]]
            if moe_calls:
                note_cpu_routes(grown)
            expect = {rid: [] for rid in grown}
            for req, _slot, lg in cpu.prefill_log:
                expect[req.rid].append(lg)
            if cpu.last_decode is not None:
                for slot in np.flatnonzero(cpu.last_decode["active"]):
                    rid = next(r for r in grown if creqs[r].slot == slot)
                    expect[rid].append(cpu.last_decode["logits"][slot])
            state["expect"] = expect
            gpu.step()
            if any(expect.values()):
                raise AssertionError("the CUDA engine emitted fewer tokens")
            if (dataclasses.asdict(gpu.trace.iterations[-1])
                    != dataclasses.asdict(cpu.trace.iterations[-1])):
                raise AssertionError("iteration records differ")
    finally:
        L.route = route
    for eng in (cpu, gpu):
        if eng.data_plane is not None:
            eng.data_plane.sync()
    done = [sorted((r.rid, tuple(r.generated)) for r in e.finished)
            for e in (cpu, gpu)]
    log(f"{name}: {len(gpu.finished)} finished, "
        f"{state['compares']} token compares, {state['ties']} ties, "
        f"{state['route_apart']} emissions routed apart, "
        f"{state['route_ties']} of them beyond the tolerance or on "
        f"another token, decode graph captures {gpu.decode_graph_captures}, "
        f"max logit |err| {state['err']:.4g}, interval {gpu.interval}, "
        f"streamed pages peak {gpu.streamed_pages_peak}, chunk pages "
        f"streamed {gpu.chunk_pages_streamed}, prefill tokens computed "
        f"{gpu.prefill_tokens_computed} / {cpu.prefill_tokens_computed}, "
        f"parks {gpu.scheduler.stats['preemptions']}, disk pages out "
        f"{gpu.kv.disk_out_pages_total}, records "
        f"{len(gpu.trace.iterations)} equal")
    if done[0] != done[1] or len(done[1]) != len(prompts):
        raise AssertionError("CUDA and CPU engines finished differently")
    if state["ties"] > max(1, 0.05 * state["compares"]):
        raise AssertionError(f"too many ties: {state['ties']}")
    if state["route_apart"] > MOE_ROUTED_APART * state["compares"]:
        raise AssertionError(f"{state['route_apart']} of "
                             f"{state['compares']} emissions routed apart")
    if moe_calls and len(captured) != moe_calls * gpu.decode_graph_captures:
        raise AssertionError("the decode graphs' MoE calls were not all "
                             "recorded")
    if gpu.prefetch_copies <= 0 or gpu.streamed_pages_peak <= 0:
        raise AssertionError("the reference trace bypassed offloading")
    if gpu.prefill_tokens_computed != cpu.prefill_tokens_computed:
        raise AssertionError("CUDA and CPU engines computed different "
                             "prefill tokens")
    if incremental and (gpu.chunk_pages_streamed <= 0
                        or gpu.prefill_tokens_computed
                        != sum(len(p) for p in prompts)):
        raise AssertionError("the incremental trace bypassed the chunk path "
                             "over host pages, or was not linear")
    if disk and not (gpu.scheduler.stats["preemptions"] > 0
                     and gpu.kv.disk_out_pages_total > 0
                     and gpu._trace_footer() == cpu._trace_footer()):
        raise AssertionError("the disk trace did not reach the disk, or the "
                             "engines' footers differ")


def cli_phase(extra: tuple[str, ...] = (), trace: str = "smoke_cli_trace",
              want: dict | None = None) -> None:
    """The serve CLI on the reduced default config; ``want`` holds summary
    keys and the values they must have."""
    from repro_torch.launch import serve

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(["--device", "cuda", "--hw", "h100", "--requests",
                          "6", "--host-kv-gb", "0.0001", *extra,
                          "--metrics-out", str(out_dir / f"{trace}.json")])
    summary = json.loads(buf.getvalue())
    log(buf.getvalue().rstrip())
    if out["finished"] + out["rejected"] != 6 or out["finished"] == 0:
        raise AssertionError(f"serve CLI {list(extra)}: {out['finished']} "
                             f"finished, {out['rejected']} rejected of 6")
    for key, value in (want or {}).items():
        if summary[key] != value:
            raise AssertionError(f"serve CLI {list(extra)}: {key} = "
                                 f"{summary[key]}, not {value}")


# ---------------------------------------------------------------------------
# Phase 8: the MoE decoder (dbrx-132b at full width) through the engine
# ---------------------------------------------------------------------------

# host memory the 4-layer MoE engine needs: its 28.6 GB host master copy
# and one 6.52 GB pinned unit (on an H100 machine the phase's resident set
# grew 28.57 GB at the build; the pinned unit does not show in it)
MOE_HOST_GB = 36
# relative L2 bound of one full-width MoE block's decode output in bf16
# against the same block in fp32
MOE_BLOCK_REL_L2 = 2e-2


def host_memory_gb() -> dict:
    """``free -g``'s Mem line: total and available GB on this machine."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         check=True).stdout
    log("free -g:\n" + out.rstrip())
    mem = next(ln.split() for ln in out.splitlines()
               if ln.startswith("Mem:"))
    return {"total_gb": int(mem[1]), "available_gb": int(mem[-1])}


def host_rss_gb() -> float:
    """This process's resident host memory in GB (``VmRSS``)."""
    line = next(ln for ln in Path("/proc/self/status").read_text()
                .splitlines() if ln.startswith("VmRSS:"))
    return int(line.split()[1]) * 1024 / 1e9


@contextlib.contextmanager
def plain_decode_attention():
    """The model's paged decode attention through the kernel's plain
    version, which takes any dtype (for an fp32 block on the card)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops

    kernel = ops.paged_decode_attention
    ops.paged_decode_attention = DA.paged_decode_attention_plain
    try:
        yield
    finally:
        ops.paged_decode_attention = kernel


def moe_kernel_checks(cfg, pool: torch.Tensor) -> dict:
    """The decode and flash kernels at the MoE path's shapes (48 heads
    over 8 KV heads, g 6, head_dim 128), against their plain versions and
    timed beside their bounds: decode over a layer slice of the engine's
    pool at batch 8 and 2919 context tokens, flash at the bucketed
    1024-token prefill."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    h, vh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    page = pool.shape[1]
    nb = MAX_SEQ // page
    frames = torch.randperm(pool.shape[0] - 1, generator=gen,
                            device=dev)[:8 * nb]
    pool.index_copy_(0, frames, torch.randn(
        (8 * nb, *pool.shape[1:]), generator=gen, device=dev).to(pool.dtype))
    kp, vp = pool[:, :, 1, 0], pool[:, :, 1, 1]
    q = torch.randn((8, h, d), generator=gen, device=dev).to(torch.bfloat16)
    bt = frames.reshape(8, nb).to(torch.int32)
    cl = torch.tensor([1024, 1000, 513, 17, 1, 0, 300, 64],
                      dtype=torch.int32, device=dev)
    decode = lambda: DA.paged_decode_attention(q, kp, vp, bt, cl)
    err_d = max_err(decode(), DA.paged_decode_attention_plain(
        q, kp, vp, bt, cl), "moe paged_decode")
    qs, ks, vs = (torch.randn((1, MAX_SEQ, n, d), generator=gen, device=dev)
                  .to(torch.bfloat16).transpose(1, 2) for n in (h, vh, vh))
    flash = lambda: FA.flash_attention(qs, ks, vs)
    err_f = max_err(flash(), FA.flash_attention_plain(qs, ks, vs),
                    "moe flash")
    tokens = int(cl.sum())
    d_bytes = tokens * vh * d * 2 * 2 + 2 * 8 * h * d * 2 + bt.numel() * 4
    pairs = MAX_SEQ * (MAX_SEQ + 1) // 2
    f_ops = 4 * h * pairs * d
    out = {"decode": {"B": 8, "tokens": tokens, "max_abs_err": err_d,
                      "ms": time_ms(decode),
                      "bound_ms": max(d_bytes / HBM_BYTES_S,
                                      4 * tokens * h * d / BF16_FLOPS_S)
                      * 1e3},
           "flash": {"S": MAX_SEQ, "max_abs_err": err_f,
                     "ms": time_ms(flash),
                     "bound_ms": max(f_ops / BF16_FLOPS_S,
                                     2 * 2 * (qs.numel() + ks.numel()
                                              + vs.numel()) / HBM_BYTES_S)
                     * 1e3}}
    pool.zero_()
    return out


def route_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """How far each token's top-k routing lies from a tie: the gap between
    its k-th and (k+1)-th router probabilities over the k-th."""
    top = probs.sort(dim=-1, descending=True).values
    return (top[..., k - 1] - top[..., k]) / top[..., k - 1]


def moe_block_vs_fp32(eng, placed) -> dict:
    """One full-width MoE block (the first resident unit's) decoding a
    batch of 8 at 1024-token contexts on the card in bf16, through the
    paged decode kernel, against the same block, weights, pool and input
    in fp32 (plain attention, no TF32). The router sees each run's own
    attention output, so a row whose top-k boundary lies near a tie may
    route through other experts in the two runs: such rows must have a
    route margin below ``ROUTE_TIE``, at most half the rows may, and the
    rows that route alike are held at ``MOE_BLOCK_REL_L2``, in the block's
    output and in its update (output minus input). Returns those relative
    L2s, the output's over all rows, and the rows that routed apart."""
    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import tree_map

    cfg, dev = eng.cfg, eng.device
    gen = torch.Generator(dev).manual_seed(12)
    blk = T.unit_slice(T.unit_slice(placed["blocks"]["resident"], 0), 0)[0]
    pool = decode_pool(cfg, eng.model.virtual_kv, 8, MAX_SEQ, dev)
    pool.copy_(torch.randn(pool.shape, generator=gen, device=dev))
    d = paged_decode_inputs(pool, 8, MAX_SEQ)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    args = (d.block_tables, d.context_lens, d.write_frames, d.write_offsets,
            eng.model.virtual_kv)
    routes, route = [], L.route

    def watched(c, p, h):
        probs, top_p, top_i = route(c, p, h)
        routes.append((top_i[:, 0].sort().values,
                       route_margin(probs, c.moe.top_k)[:, 0]))
        return probs, top_p, top_i

    L.route = watched
    try:
        got, _ = T.apply_block_decode_paged(cfg, cfg.pattern[0], blk, x,
                                            d.pos, pool.clone(), 0, *args)
        blk32 = tree_map(lambda t: t.float(), blk)
        with plain_decode_attention():
            want, _ = T.apply_block_decode_paged(
                cfg, cfg.pattern[0], blk32, x.float(), d.pos, pool.float(),
                0, *args)
        del blk32
    finally:
        L.route = route
    (top16, margin16), (top32, margin32) = routes
    apart = (top16 != top32).any(-1)
    near = torch.minimum(margin16, margin32) < ROUTE_TIE
    alike = ~apart
    got, xf = got.float()[:, 0], x.float()[:, 0]
    want = want[:, 0]
    rel = lambda a, b: float((a - b).norm() / b.norm())
    return {"rows_routed_apart": apart.nonzero().flatten().tolist(),
            "apart_rows_near_a_tie": bool(near[apart].all()),
            "route_margins_fp32": margin32.tolist(),
            "rel_l2_output": rel(got[alike], want[alike]),
            "rel_l2_update": rel(got[alike] - xf[alike],
                                 want[alike] - xf[alike]),
            "rel_l2_output_all_rows": rel(got, want),
            "max_abs_err": float((got[alike] - want[alike]).abs().max())}


def moe_phase() -> dict:
    """The MoE decoder on the main serving path: dbrx-132b at full width
    (``profile_engine.moe_config``; depth cut to 4 layers for host memory,
    2 when the machine cannot hold ``MOE_HOST_GB``), held at the interval
    of one group (at 4 layers: three resident units, one 6.52 GB unit
    streamed from pinned host memory by the weight ring every step), 40
    device and 128 host KV pages. Its weights are placed first and the
    ring's copies out of that pinned stack walked (``placement_link``): the
    engine's records and clock take the datasheet ``h100`` preset with the
    slowest walk's link, it serves from that placement, at the TPOT SLO
    that clock certifies. Serves 8 requests of 17-512 prompt tokens with 8
    new tokens each through the one-shot bucketed prefill (flash kernel)
    and the CUDA-graph decode step (paged decode kernel); every request
    finishes, audit clean, both kernels launched on this path, the decode
    graph captured, prefetch copies made and one unit's bytes pinned. Logs
    the share of decode steps within the certified SLO and the process's
    host memory before and after. Then: the kernels at this path's shapes
    against their plain versions, prefix KV bits independent of the prompt
    length, the prefill logits against plain attention, the decode graph's
    replay against the eager step bit for bit, and one block's decode
    output against fp32. Returns the path's launches."""
    from repro_torch.core import costs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.memory_manager import merge_stacked
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.profile_engine import (MOE_LAYERS, PROMPT_LENS,
                                                   calibrate_units,
                                                   measured_tpot_slo,
                                                   moe_config, moe_engine,
                                                   moe_hardware,
                                                   placement_link, ring_walks,
                                                   smoke_requests, walk_again)

    # the engines of the earlier phases hold reference cycles (fleets,
    # routers, forced-token closures): collect them and return their
    # device memory before a 28.6 GB model is drawn on the card
    gc.collect()
    torch.cuda.empty_cache()
    mem = host_memory_gb()
    mem["device_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    mem["rss_gb_before"] = host_rss_gb()
    layers = MOE_LAYERS if mem["available_gb"] >= MOE_HOST_GB else 2
    log(f"moe: host memory {json.dumps(mem)}; depth {layers} layers"
        + ("" if layers == MOE_LAYERS else
           f" (cut from {MOE_LAYERS}: under {MOE_HOST_GB} GB available)"))
    t0 = time.perf_counter()
    cfg, ecfg, interval = moe_config(layers)
    latency = PRESETS["h100"].host_link_latency_s
    placement = placement_link(cfg, interval, latency)
    # Queue C 6 on this path: the step's compute terms fitted to dbrx's
    # own unit times on the card (graph replays), the LM-head rest fitted
    # apart, and the link from the slowest of twenty walks, the second ten
    # just before serving
    units = calibrate_units(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    walk_sets = walk_again(placement, latency)
    hw = moe_hardware(cfg, units, placement["link"])
    log("moe_calibration: " + json.dumps({
        "units": units, "walk_sets": walk_sets,
        "fitted": {k: getattr(hw, k) for k in (
            "compute_eff", "mem_eff", "host_link_bw",
            "host_link_latency_s")}}))
    eng = moe_engine(cfg, ecfg, placement, hw,
                     rest_mem_eff=units["rest"]["mem_eff"])
    rt, params = eng._rt()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem["rss_gb_built"] = host_rss_gb()
    unit_bytes = costs.unit_weight_bytes(cfg)
    # the smallest SLO at which the clock's record makes the held interval
    # the smallest feasible one
    slo = measured_tpot_slo(eng.rec["decode"], eng.times_fn, cfg, ecfg,
                            interval=interval)
    rng = np.random.default_rng(0)
    reqs = smoke_requests(cfg.vocab_size, 8, rng, PROMPT_LENS,
                          tpot_slo_s=slo)
    DA.launches = FA.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, submit_all=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    report = eng.trace.audit()
    mem["rss_gb_after_run"] = host_rss_gb()
    walks = ring_walks(rt, walks=3)
    link = placement["link"]
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "host_memory": mem,
        "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "experts": cfg.moe.num_experts,
        "top_k": cfg.moe.top_k, "unit_bytes": unit_bytes,
        "finished": out["finished"], "rejected": out["rejected"],
        "tokens": out["tokens"], "slo_ok_modeled_clock": out["slo_ok"],
        "tpot_slo_s": slo,
        "decode_steps_within_tpot_slo": sum(
            ms <= slo * 1e3 for ms in eng.decode_ms) / len(eng.decode_ms),
        "host_link_bw_used": eng.hw.host_link_bw,
        "placement_walk_gb_s_slowest": link["slowest_gb_s"],
        "placement_walk_gb_s_median": link["median_gb_s"],
        "walk_set_gb_s_slowest": [walk_sets["first"]["slowest_gb_s"],
                                  walk_sets["second"]["slowest_gb_s"]],
        "walk_sets_seconds_apart": walk_sets["seconds_between_sets"],
        "compute_eff": hw.compute_eff, "mem_eff": hw.mem_eff,
        "served_from_timed_placement": rt is placement["runtime"],
        "intervals": sorted({it.interval for it in eng.trace.iterations}),
        "host_weight_bytes": eng.host_weight_bytes,
        "prefetch_copies": eng.prefetch_copies,
        "decode_graph_captures": eng.decode_graph_captures,
        "launches": launches, "audit_ok": report.ok,
        "host_kv_peak_pages": eng.host_kv_peak_pages,
        "streamed_pages_peak": eng.streamed_pages_peak,
        "decode_iters": len(eng.decode_ms),
        "decode_stream_ms": eng.decode_ms,
        "decode_stream_ms_median": statistics.median(eng.decode_ms),
        "prefill_stream_ms_median": statistics.median(eng.prefill_ms),
        "modeled_decode_iter_ms_median": statistics.median(
            it.dt_s * 1e3 for it in eng.trace.iterations
            if it.decode_batch > 0 and not it.admitted),
        "unit_copy_ms_after_run": [t * 1e3 for t in walks["unit_copy_s"]],
        "unit_copy_gb_s_after_run": [unit_bytes / t / 1e9
                                     for t in walks["unit_copy_s"]],
        "device_memory_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "build_s": build_s, "run_s": run_s,
        "wall_modeled_s": out["wall_modeled_s"],
    }
    summary["queue_c6_rule_met"] = summary["decode_steps_within_tpot_slo"] == 1.0
    log("moe: " + json.dumps(summary))
    if out["finished"] != len(reqs):
        raise AssertionError(f"moe engine finished {out['finished']} of "
                             f"{len(reqs)} requests")
    if not report.ok:
        raise AssertionError(f"moe trace audit: {report.violations[:5]}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never ran on the MoE path: "
                             f"{launches}")
    if eng.decode_graph_captures < 1:
        raise AssertionError("the MoE decode step was not captured")
    if summary["intervals"] != [interval] or eng.prefetch_copies <= 0:
        raise AssertionError("the MoE engine did not stream a unit at "
                             f"interval {interval}")
    if eng.host_weight_bytes != unit_bytes or eng._placements != 1:
        raise AssertionError(f"pinned {eng.host_weight_bytes} bytes in "
                             f"{eng._placements} placements, not one "
                             f"unit's {unit_bytes} in the timed one")
    for r in eng.finished:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < cfg.padded_vocab() for t in r.generated):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.generated}")

    kern = moe_kernel_checks(cfg, torch.zeros_like(eng.pool))
    log(f"moe_kernels: decode and flash at H {cfg.num_heads}, V "
        f"{cfg.num_kv_heads}, D {cfg.resolved_head_dim} against their plain "
        f"versions and timed: {json.dumps(kern)}")

    # bucketed-prefill bitwise contract: a shared 2-page prefix gets the
    # same KV bits whatever the prompt length it was computed under
    page = eng.ecfg.page_size
    shared = rng.integers(0, cfg.vocab_size, 2 * page).astype(np.int32)
    a, b = (np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in (45, 301))
    kv = []
    for p in (a, b):
        _, caches, _ = eng._bucketed_prefill(p, len(p))
        merged = merge_stacked(caches, rt.plan)
        kv.append([(m["self"]["k"][:, :, :2 * page],
                    m["self"]["v"][:, :, :2 * page]) for m in merged])
    same = all(torch.equal(x, y) for (ka, va), (kb, vb) in zip(*kv)
               for x, y in ((ka, kb), (va, vb)))
    log(f"moe_prefix_kv_bitwise: {same} (prompts {len(a)} and {len(b)} "
        f"tokens, shared {2 * page})")
    if not same:
        raise AssertionError("MoE prefix KV bits depend on the prompt length")
    del kv

    # the prefill through the flash kernel against plain dense attention
    toks = {"tokens": torch.as_tensor(b, device=eng.device)[None]}
    got, _, _ = rt.prefill(params, toks, len(b))
    want, _, _ = rt.prefill(params, toks, len(b), attn_impl="reference")
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    argmax_equal = bool(got.argmax() == want.argmax())
    log(f"moe_prefill_vs_plain_attention: rel_l2 {rel:.4g} (bound "
        f"{FULL_REL_L2}), max_abs_err {float((got - want).abs().max()):.4g}, "
        f"argmax equal {argmax_equal}")
    if not (rel <= FULL_REL_L2 and argmax_equal):
        raise AssertionError("MoE prefill logits disagree with the plain "
                             "attention path")

    # the decode graph's replay against the eager step on its inputs
    graph = eng._decode_graph[1]
    pool = graph.inputs[2]
    before = pool.clone()
    replayed = graph.replay()[0].clone()
    pool_replayed = pool.clone()
    pool.copy_(before)
    eager, _ = rt.paged_decode_step(params, *graph.inputs)
    torch.cuda.synchronize()
    bitwise = torch.equal(replayed, eager) and torch.equal(pool_replayed,
                                                           pool)
    log(f"moe_decode_graph_replay_bitwise_eager: {bitwise}")
    if not bitwise:
        raise AssertionError("the MoE decode graph's replay differs from "
                             "the eager step")
    del before, pool_replayed

    block = moe_block_vs_fp32(eng, params)
    log(f"moe_block_vs_fp32: {json.dumps(block)} (bound "
        f"{MOE_BLOCK_REL_L2} on the output and the update of the rows that "
        f"route alike)")
    if not (block["rel_l2_output"] <= MOE_BLOCK_REL_L2
            and block["rel_l2_update"] <= MOE_BLOCK_REL_L2
            and block["apart_rows_near_a_tie"]
            and 2 * len(block["rows_routed_apart"]) <= 8):
        raise AssertionError("the MoE block's bf16 decode output disagrees "
                             "with fp32")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: gemma-2b (head_dim 256) through the engine
# ---------------------------------------------------------------------------


def _serve(eng, reqs) -> tuple[dict, dict]:
    """Run ``reqs`` on ``eng`` with the kernels' counts set to 0 just
    before: (the run's summary, its launches by kernel)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA

    DA.launches = FA.launches = PA.launches = 0
    t0 = time.perf_counter()
    out = eng.run(reqs, submit_all=True)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches,
                "paged_chunk_attention": PA.launches}
    report = eng.trace.audit()
    if out["finished"] != len(reqs):
        raise AssertionError(f"{eng.name}: finished {out['finished']} of "
                             f"{len(reqs)} requests")
    if not report.ok:
        raise AssertionError(f"trace audit: {report.violations[:5]}")
    for r in eng.finished:
        if len(r.generated) != r.max_new_tokens or not all(
                0 <= t < eng.cfg.padded_vocab() for t in r.generated):
            raise AssertionError(f"rid {r.rid}: bad tokens {r.generated}")
    return out, launches


def gemma_phase() -> dict:
    """gemma-2b at full width (18 layers, d_model 2048, 8 heads over 1 KV
    head, head_dim 256, d_ff 16384, vocab 256000; random weights, seed 0)
    through the engine at the smoke engine's settings: a one-shot run of
    the smoke requests (17-512 prompt tokens, 16 new tokens) through the
    flash and decode kernels at D 256, a second run of the same weights and
    requests whose greedy tokens must be bitwise the first's, and an
    incremental run with 256-token chunks through the chunk kernel at
    D 256. The longest prompt's prefill logits are held against plain
    attention. Returns each D 256 kernel's launches on this path (decode
    and flash from the first run, chunk from the incremental one)."""
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.launch.profile_engine import smoke_engine, smoke_requests

    eng = smoke_engine(arch="gemma-2b")
    cfg = eng.cfg
    reqs = smoke_requests(cfg.vocab_size, 16, np.random.default_rng(0))
    out, launches = _serve(eng, reqs)
    intervals = sorted({it.interval for it in eng.trace.iterations})
    tokens = {r.rid: list(r.generated) for r in eng.finished}
    summary = {"finished": out["finished"], "tokens": out["tokens"],
               "launches": launches, "intervals": intervals,
               "prefetch_copies": eng.prefetch_copies,
               "host_weight_bytes": eng.host_weight_bytes,
               "decode_graph_captures": eng.decode_graph_captures,
               "decode_stream_ms_median": statistics.median(eng.decode_ms),
               "prefill_stream_ms_median": statistics.median(eng.prefill_ms),
               "run_s": out["run_s"]}
    log("gemma_engine: " + json.dumps(summary))
    if not (launches["paged_decode_attention"] > 0
            and launches["flash_attention"] > 0):
        raise AssertionError(f"a D 256 kernel never ran: {launches}")
    if max(intervals) >= NO_OFFLOAD or eng.prefetch_copies <= 0:
        raise AssertionError("gemma: no weight unit was offloaded")

    # the longest prompt's prefill through the flash kernel against plain
    # dense attention, on the card
    rt, placed = eng._rt()
    longest = max(reqs, key=lambda r: r.prompt_len)
    toks = {"tokens": torch.as_tensor(longest.prompt, device="cuda")[None]}
    got, _, _ = rt.prefill(placed, toks, longest.prompt_len)
    want, _, _ = rt.prefill(placed, toks, longest.prompt_len,
                            attn_impl="reference")
    got, want = got.float(), want.float()
    rel = float((got - want).norm() / want.norm())
    same_top = bool(got.argmax() == want.argmax())
    log(f"gemma_prefill_vs_plain_attention: prompt {longest.prompt_len}, "
        f"rel_l2 {rel:.4g} (bound {FULL_REL_L2}), argmax equal {same_top}")
    if not (rel <= FULL_REL_L2 and same_top):
        raise AssertionError("gemma prefill logits disagree with plain "
                             "attention")
    params = eng.params
    del eng, rt, placed
    gc.collect()
    torch.cuda.empty_cache()

    # a second run of the same weights and requests: greedy tokens bitwise
    again = smoke_engine(arch="gemma-2b", params=params)
    _serve(again, smoke_requests(cfg.vocab_size, 16,
                                 np.random.default_rng(0)))
    same = {r.rid: list(r.generated) for r in again.finished} == tokens
    log(f"gemma_tokens_bitwise_second_run: {same}")
    if not same:
        raise AssertionError("gemma: the graphed decode's greedy tokens "
                             "differ between two runs")
    del again
    gc.collect()
    torch.cuda.empty_cache()

    inc = smoke_engine(arch="gemma-2b", prefill_chunk_tokens=256,
                       incremental_prefill=True, params=params)
    inc_reqs = smoke_requests(cfg.vocab_size, 16, np.random.default_rng(0))
    out, inc_launches = _serve(inc, inc_reqs)
    prompt_tokens = sum(r.prompt_len for r in inc_reqs)
    log("gemma_incremental: " + json.dumps({
        "finished": out["finished"], "launches": inc_launches,
        "chunks": len(inc.chunk_ms),
        "prefill_tokens_computed": inc.prefill_tokens_computed,
        "prompt_tokens": prompt_tokens,
        "chunk_stream_ms_median": statistics.median(inc.chunk_ms),
        "run_s": out["run_s"]}))
    if inc_launches["paged_chunk_attention"] <= 0:
        raise AssertionError(f"the chunk kernel never ran: {inc_launches}")
    if inc.prefill_tokens_computed != prompt_tokens:
        raise AssertionError("gemma incremental: prompt tokens computed "
                             "more than once")
    launches["paged_chunk_attention"] = inc_launches["paged_chunk_attention"]
    del inc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 10: every model family through the dense-cache grouped decode
# ---------------------------------------------------------------------------

# grouped decode against the plain step on one card
# (tests/test_offload_equivalence.py)
GROUPED_TOL = dict(rtol=3e-2, atol=6e-2)
# relative L2 bound of a Mamba block's bf16 output against the block in fp32
MAMBA_REL_L2 = 2e-2


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@contextlib.contextmanager
def recorded_routes():
    """Each MoE call's expert sets ([B, S, k], ids ascending, on the CPU)
    while the block is open (``layers.route`` wrapped)."""
    from repro_torch.models import layers as L

    route, calls = L.route, []

    def watched(cfg, p, x):
        probs, top_p, top_i = route(cfg, p, x)
        calls.append(top_i.sort(dim=-1).values.cpu())
        return probs, top_p, top_i

    L.route = watched
    try:
        yield calls
    finally:
        L.route = route


def _ms(fn) -> tuple[float, object]:
    """One call's stream time (CUDA events) and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def family_run(cfg, inputs: dict, cache_len: int, interval: int,
               steps: int) -> dict:
    """One model family through ``OffloadRuntime``: weights from seed 0
    placed at ``interval`` (offloaded units pinned on the host), the
    prefill (flash) held against plain attention, then ``steps`` greedy
    decode steps as one CUDA graph, each held bitwise against the eager
    grouped step on a copy of the caches and, at the grouped tolerance,
    against ``Model.decode_step`` on the merged weights and caches."""
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 merge_model_params,
                                                 merge_stacked,
                                                 split_model_params)
    from repro_torch.models.model import build_model
    from repro_torch.models.spec import tree_leaves, tree_map
    from repro_torch.models.transformer import pattern_info

    dev = torch.device("cuda")
    model = build_model(cfg)
    _, units = pattern_info(cfg)
    plan = OffloadPlan(units, interval)
    rt = OffloadRuntime(model, plan, dev)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    placed = rt.place(split_model_params(params, plan))
    # the plain step's weights: the same tensors, the offloaded units
    # back on the device
    plain = merge_model_params(tree_map(lambda t: t.to(dev), placed), plan)
    del params
    copies0 = rt.prefetch_copies
    with recorded_routes() as flash_routes:
        prefill_ms, (logits, caches, enc_pos) = _ms(
            lambda: rt.prefill(placed, inputs, cache_len))
    with recorded_routes() as plain_routes:
        want, _, _ = rt.prefill(placed, inputs, cache_len,
                                attn_impl="reference")
    # a MoE row whose tokens the two prefills routed through different
    # experts (a bf16 routing tie, ROADMAP Queue C 8) is excused; every
    # other row is held to plain attention
    alike = torch.ones(logits.shape[0], dtype=torch.bool)
    for a, b in zip(flash_routes, plain_routes):
        alike &= (a == b).flatten(1).all(-1)
    rel = _rel_l2(logits[alike], want[alike]) if alike.any() else None
    if alike.any() and not (rel <= FULL_REL_L2 and torch.equal(
            logits[alike].argmax(-1), want[alike].argmax(-1))):
        raise AssertionError(f"{cfg.name}: prefill against plain attention "
                             f"rel_l2 {rel:.4g}")
    plain_c = merge_stacked(caches, plan)
    eager_c = tree_map(torch.clone, caches)
    b = logits.shape[0]
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((b,), inputs["tokens"].shape[1] + (
        inputs["frontend_embeds"].shape[1] if "frontend_embeds" in inputs
        else 0), dtype=torch.int32, device=dev)
    g_tok, g_pos = tok.clone(), pos.clone()
    graph = rt.capture_decode(placed, g_tok, g_pos, caches, enc_pos)
    decode_ms, worst, ties = [], 0.0, 0
    for _ in range(steps):
        ms, (got, _) = _ms(graph.replay)
        decode_ms.append(ms)
        eager, _ = rt.decode_step(placed, tok, pos, eager_c, enc_pos)
        ref, plain_c = model.decode_step(plain, tok, pos, plain_c, enc_pos)
        if not torch.equal(got, eager) or not all(
                torch.equal(x, y) for x, y in zip(tree_leaves(caches),
                                                  tree_leaves(eager_c))):
            raise AssertionError(f"{cfg.name}: graph replay differs from "
                                 f"the eager grouped step")
        g, w = got.float(), ref.float()
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, **GROUPED_TOL):
            raise AssertionError(f"{cfg.name}: grouped decode against the "
                                 f"plain step, max |err| "
                                 f"{float((g - w).abs().max()):.4g}")
        for gr, wr in zip(g, w):
            gi, wi = int(gr.argmax()), int(wr.argmax())
            if gi != wi:
                tie = GROUPED_TOL["atol"] + GROUPED_TOL["rtol"] * abs(
                    float(wr[wi]))
                if not (wr[wi] - wr[gi] <= tie and gr[gi] - gr[wi] <= tie):
                    raise AssertionError(f"{cfg.name}: argmax {gi} vs {wi}")
                ties += 1
        tok = got.argmax(-1).to(torch.int32)
        pos = pos + 1
        g_tok.copy_(tok)
        g_pos.copy_(pos)
    torch.cuda.synchronize()
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "batch": b,
           "interval": interval, "groups": plan.num_groups,
           "prefill_rel_l2": rel, "prefill_ms": prefill_ms,
           "prefill_rows_routed_apart": int((~alike).sum()),
           "decode_stream_ms_median": statistics.median(decode_ms),
           "decode_stream_ms_max": max(decode_ms),
           "grouped_vs_plain_max_abs": worst, "argmax_ties": ties,
           "graph_bitwise_eager": True,
           "prefetch_copies": rt.prefetch_copies - copies0,
           "host_weight_bytes": rt.host_weight_bytes,
           # this run's device peak above what earlier phases still hold
           "device_peak_bytes": torch.cuda.max_memory_allocated() - before}
    # two prefills, and per step the replay and the eager grouped step: one
    # copy per group each (the capture takes back its warm-up's copies)
    want = plan.num_groups * (2 + 2 * steps) if rt._stream else 0
    if out["prefetch_copies"] != want:
        raise AssertionError(f"{cfg.name}: {out['prefetch_copies']} "
                             f"prefetch copies, not {want}")
    return out


def jamba_blocks(steps: int = 8, s: int = 1024, b: int = 2) -> dict:
    """jamba-1.5-large-398b's Mamba block (pattern position 0, dense MLP)
    and attention block (position 4) at full width, each built alone
    (random weights, seed 0): ``apply_block_seq`` over S, then ``steps``
    ``apply_block_decode`` steps from its cache. The Mamba block in bf16 is
    held against the same block in fp32 (relative L2), seq(S) then
    decode(1) against the last row of seq(S + 1), and the attention
    block's flash prefill against plain attention."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.spec import initialize, tree_leaves, tree_map

    dev = torch.device("cuda")
    cfg = get_config("jamba-1.5-large-398b")
    vkv = cfg.num_kv_heads
    gen = torch.Generator(dev).manual_seed(0)
    x = (torch.randn((b, s + 1 + steps, cfg.d_model), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    out = {}
    for j in (0, 4):
        blk = cfg.pattern[j]
        p = initialize(T.block_spec(cfg, blk), gen, dev)
        ctx = T.SeqCtx(positions=pos, want_cache=True, cache_len=s + steps,
                       virtual_kv=vkv)
        seq_ms, (y, cache, _) = _ms(lambda: T.apply_block_seq(
            cfg, blk, p, x[:, :s], ctx))
        dec_ms, outs = [], []
        for t in range(steps):
            ms, (yt, cache) = _ms(lambda: T.apply_block_decode(
                cfg, blk, p, x[:, s + t:s + t + 1],
                torch.full((b,), s + t, dtype=torch.int32, device=dev),
                cache, vkv))
            dec_ms.append(ms)
            outs.append(yt)
        row = {"mixer": blk.mixer, "mlp": blk.mlp, "seq_ms": seq_ms,
               "decode_ms_median": statistics.median(dec_ms),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in tree_leaves(p))}
        if blk.mixer == "mamba":
            # the same block in fp32 on the same (bf16-valued) inputs
            p32 = tree_map(lambda t: t.float(), p)
            y32, c32, _ = T.apply_block_seq(cfg, blk, p32, x[:, :s].float(),
                                            ctx)
            rel_seq = _rel_l2(y, y32)
            rel_dec = 0.0
            for t in range(steps):
                y1, c32 = T.apply_block_decode(
                    cfg, blk, p32, x[:, s + t:s + t + 1].float(),
                    torch.full((b,), s + t, dtype=torch.int32, device=dev),
                    c32, vkv)
                rel_dec = max(rel_dec, _rel_l2(outs[t], y1))
            # state continuity: seq(S) then decode(1) is seq(S + 1)'s row S
            ctx1 = T.SeqCtx(positions=torch.arange(
                s + 1, dtype=torch.int32, device=dev).expand(b, s + 1),
                virtual_kv=vkv)
            y_all, _, _ = T.apply_block_seq(cfg, blk, p, x[:, :s + 1], ctx1)
            rel_cont = _rel_l2(outs[0][:, 0], y_all[:, s])
            row.update({"rel_l2_vs_fp32_seq": rel_seq,
                        "rel_l2_vs_fp32_decode_max": rel_dec,
                        "state_continuity_rel_l2": rel_cont})
            if not max(rel_seq, rel_dec, rel_cont) <= MAMBA_REL_L2:
                raise AssertionError(f"jamba Mamba block: {row}")
            del p32, c32, y32
        else:
            ref, _, _ = T.apply_block_seq(cfg, blk, p, x[:, :s],
                                          dataclasses.replace(
                                              ctx, attn_impl="reference"))
            row["prefill_rel_l2_vs_plain_attention"] = _rel_l2(y, ref)
            if not row["prefill_rel_l2_vs_plain_attention"] <= FULL_REL_L2:
                raise AssertionError(f"jamba attention block: {row}")
        out[f"position_{j}"] = row
        del p, cache
        gc.collect()
        torch.cuda.empty_cache()
    return out


def families_phase() -> dict:
    """xlstm-125m, paligemma-3b and seamless-m4t-medium at full width and
    depth, and jamba-1.5-large-398b's blocks at full width and its reduced
    model end to end, through ``OffloadRuntime.prefill`` /
    ``.decode_step`` (``family_run``; jamba's blocks, ``jamba_blocks``).
    Stub embeddings come from a numpy seed. Returns the flash kernel's
    launches on this path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PA

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def stub(b, n, d):
        return torch.from_numpy((rng.standard_normal((b, n, d)) * 0.02)
                                .astype(np.float32)).to(dev, torch.bfloat16)

    def toks(cfg, b, n):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, n))
                                .astype(np.int32)).to(dev)

    xl = get_config("xlstm-125m")
    pg = get_config("paligemma-3b")
    sm = get_config("seamless-m4t-medium")
    jr = reduce_config(get_config("jamba-1.5-large-398b"), layers=16)
    runs = [(xl, {"tokens": toks(xl, 4, 512)}, 512 + 16, 2),
            (pg, {"frontend_embeds": stub(2, 256, pg.d_model),
                  "tokens": toks(pg, 2, 256)}, 512 + 16, 3),
            (sm, {"enc_embeds": stub(2, 1024, sm.d_model),
                  "tokens": toks(sm, 2, 64)}, 64 + 16, 3),
            (jr, {"tokens": toks(jr, 2, 64)}, 64 + 16, 2)]
    DA.launches = FA.launches = PA.launches = 0
    results = []
    for cfg, inputs, cache_len, interval in runs:
        t0 = time.perf_counter()
        row = family_run(cfg, inputs, cache_len, interval, 16)
        row["wall_s"] = time.perf_counter() - t0
        if cfg is jr:
            row["reduced"] = ["d_model 8192 -> 64", "heads 64 -> 4",
                              "layers 72 -> 16 (2 periods)",
                              "d_ff 24576 -> 128", "vocab 65536 -> 512",
                              "experts 16 -> 4", "mamba d_state 16 -> 8"]
        log("families: " + json.dumps(row))
        results.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    blocks = jamba_blocks()
    launches = FA.launches
    blocks["reduced"] = ["blocks only: pattern positions 0 (Mamba + dense "
                         "MLP) and 4 (attention + dense MLP) built alone, "
                         "no MoE layer, no embedding or LM head"]
    log("families_jamba_blocks: " + json.dumps(blocks))
    if launches <= 0:
        raise AssertionError("the flash kernel never ran on the families "
                             "path")
    log(f"families path launches: flash {launches}, decode {DA.launches}, "
        f"chunk {PA.launches}")
    return {"flash_attention": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build = _build.build_all()
    log(f"kernel build seconds: {json.dumps(build)}")
    for name in _build.SOURCES:
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"ptxas {name}: {' | '.join(regs)}")

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kernels = [check_decode(flush), check_flash(flush), check_chunk(flush)]
    kernels += check_d256(flush)
    del flush
    log("kernels checked: " + json.dumps(
        {k["name"]: k["check"] for k in kernels}))

    # each kernel's launches come from its own path: decode and flash from
    # the one-shot engine run, the chunk kernel from the incremental one
    launches = engine_phase()
    launches["paged_chunk_attention"] = incremental_phase()
    for k in kernels:
        if k["name"] in launches:        # the D 256 rows: gemma_phase
            k["launches"] = launches[k["name"]]
    disk_launches = disk_phase(card)
    log(f"disk path launches (async run): {json.dumps(disk_launches)}")
    calibration = calibration_phase(card)
    measured = measured_engine_phase(calibration)
    baselines_phase(calibration, measured)
    del calibration, measured
    fleet_launches = fleet_phase(card)
    log(f"fleet path launches: {json.dumps(fleet_launches)}")
    reference_phase()
    reference_phase("incremental_lockstep", incremental=True)
    reference_phase("disk_lockstep", disk=True)
    cli_phase()
    cli_phase(("--prefill-chunk-tokens", "16", "--incremental-prefill"),
              "smoke_cli_incremental_trace")
    cli_phase(("--preemption", "--disk-kv-gb", "0.0001", "--async-data-plane"),
              "smoke_cli_disk_trace", want={"kv_tiers": 3})
    cli_phase(("--fleet", "2"), "smoke_cli_fleet_trace",
              want={"instances": 2})
    cli_phase(("--disagg",), "smoke_cli_disagg_trace",
              want={"disagg": True})
    moe_launches = moe_phase()
    log(f"moe path launches: {json.dumps(moe_launches)}")
    reference_phase("moe_lockstep", arch="dbrx-132b")
    cli_phase(("--arch", "dbrx-132b"), "smoke_cli_moe_trace")
    gc.collect()
    torch.cuda.empty_cache()
    d256 = gemma_phase()
    log(f"gemma path launches: {json.dumps(d256)}")
    for k in kernels:
        if k["name"].endswith("_d256"):
            k["launches"] = d256[k["name"][:-len("_d256")]]
    families = families_phase()
    log(f"families path launches: {json.dumps(families)}")

    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(card)                       # name, power limit as nvidia-smi gives
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "check")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
