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
   context gathered beforehand, as a reference point).
3. Full-width qwen2.5-3b (random weights, seed 0) served by the port's
   engine with online interval autotuning and a host KV tier: every request
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
   agree with its one-shot prefill.
4. The CUDA engine in lockstep with the same engine on the CPU (the
   kernels' plain versions) on a small model at interval 2 with a host KV
   tier, once with one-shot prefills and once with incremental chunked
   prefill: equal iteration records, logits within the DualEngine
   tolerance.
5. The port's serve CLI on the reduced default config, with one-shot and
   with incremental chunked prefill.

Prints a JSON ``kernels`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when there is no GPU or any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:71",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
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
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"(kernel / sdpa {ms / lib_ms:.3f}) bound_ms={bound_ms:.5f}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
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
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
        f"sdpa_pregathered_ms={sdpa_ms:.5f} (max |diff| {sdpa_err:.3g}, "
        f"kernel / sdpa {ms / sdpa_ms:.3f})")
    log(f"paged_chunk ptxas: {' | '.join(ptxas)}")
    return {"name": "paged_chunk_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
            "replaces": "src/repro/kernels/prefill_attention.py:78",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "check": "pass", "checks": checks}


# ---------------------------------------------------------------------------
# Phase 3: full-width engine
# ---------------------------------------------------------------------------


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


def reference_phase(name: str = "reference_lockstep",
                    incremental: bool = False) -> None:
    """The CUDA engine against the same engine on the CPU, which runs the
    kernels' plain versions: a small model, the same weights and the same
    trace, step by step. Scheduling decisions and iteration records must be
    equal, logits agree at the DualEngine tolerance, and on a numeric tie
    the CUDA engine is teacher-forced with the CPU engine's token. With
    ``incremental``, prompts prefill in 16-token chunks through the chunk
    kernel and some of those chunks read host-tier pages."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import costs
    from repro_torch.core.hardware import PRESETS
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.launch.serve import build_engine
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request

    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
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
    slos = [0.002 * k for k in range(1, 30)]
    cpu, gpu = (build_engine(f"ref-{d}", cfg, PRESETS["h100"], ecfg, slos,
                             device=d, params=params) for d in ("cpu", "cuda"))
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
    state = {"expect": {}, "compares": 0, "ties": 0, "err": 0.0}

    def forced(req, logits):
        want = state["expect"][req.rid].pop(0)
        state["err"] = max(state["err"], float(np.abs(logits - want).max()))
        if not np.allclose(logits, want, rtol=RTOL, atol=ATOL):
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
    for _ in range(300):
        if not (cpu.scheduler.has_work() or cpu._active_batch()):
            break
        before = {rid: len(r.generated) for rid, r in creqs.items()}
        cpu.step()
        grown = [rid for rid, r in creqs.items()
                 if len(r.generated) > before[rid]]
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
    done = [sorted((r.rid, tuple(r.generated)) for r in e.finished)
            for e in (cpu, gpu)]
    log(f"{name}: {len(gpu.finished)} finished, "
        f"{state['compares']} token compares, {state['ties']} ties, "
        f"max logit |err| {state['err']:.4g}, interval {gpu.interval}, "
        f"streamed pages peak {gpu.streamed_pages_peak}, chunk pages "
        f"streamed {gpu.chunk_pages_streamed}, prefill tokens computed "
        f"{gpu.prefill_tokens_computed} / {cpu.prefill_tokens_computed}, "
        f"records {len(gpu.trace.iterations)} equal")
    if done[0] != done[1] or len(done[1]) != len(prompts):
        raise AssertionError("CUDA and CPU engines finished differently")
    if state["ties"] > max(1, 0.05 * state["compares"]):
        raise AssertionError(f"too many ties: {state['ties']}")
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


def cli_phase(extra: tuple[str, ...] = (), trace: str = "smoke_cli_trace"
              ) -> None:
    from repro_torch.launch import serve

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = serve.main(["--device", "cuda", "--hw", "h100", "--requests", "6",
                      "--host-kv-gb", "0.0001", *extra, "--metrics-out",
                      str(out_dir / f"{trace}.json")])
    if out["finished"] + out["rejected"] != 6 or out["finished"] == 0:
        raise AssertionError(f"serve CLI {list(extra)}: {out['finished']} "
                             f"finished, {out['rejected']} rejected of 6")


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
    del flush
    log("kernels checked: " + json.dumps(
        {k["name"]: k["check"] for k in kernels}))

    # each kernel's launches come from its own path: decode and flash from
    # the one-shot engine run, the chunk kernel from the incremental one
    launches = engine_phase()
    launches["paged_chunk_attention"] = incremental_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    reference_phase()
    reference_phase("incremental_lockstep", incremental=True)
    cli_phase()
    cli_phase(("--prefill-chunk-tokens", "16", "--incremental-prefill"),
              "smoke_cli_incremental_trace")

    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(card)                       # name, power limit as nvidia-smi gives
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "check")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
