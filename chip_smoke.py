"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card name and power limit (nvidia-smi); build every CUDA kernel from the
   sources in ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
   parallel).
2. Kernel checks at the serving path's shapes: each kernel against its plain
   PyTorch version on the same inputs (bf16 tolerance), timed with CUDA
   events beside its bound, its plain version and, for flash attention,
   ``scaled_dot_product_attention``.
3. Full-width qwen2.5-3b (random weights, seed 0) served by the port's
   engine with online interval autotuning and a host KV tier: every request
   finishes at a finite offloading interval, the trace audit is clean, both
   kernels ran on the main path, offloaded weight units sat in pinned host
   memory and were prefetched on the side stream; then the bucketed-prefill
   bitwise contract on two prompts that share a 2-page prefix.
   The full-width prefill through the flash kernel is held against the
   same prefill through plain dense attention.
4. The CUDA engine in lockstep with the same engine on the CPU (the
   kernels' plain versions) on a small model at interval 2 with a host KV
   tier: equal iteration records, logits within the DualEngine tolerance.
5. The port's serve CLI on the reduced default config.

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
    cases = {"main": (q, bt, cl, 0)}
    bt_pad = bt.clone()
    bt_pad[0, 2:] = 99_999          # out-of-range entries past the context
    bt_pad[1, 3:] = -3
    cases["padded_oob"] = (q, bt_pad, torch.tensor(
        [18, 33, 7, 17, 45, 0, 1, 16], dtype=torch.int32, device=dev), 0)
    cases["batch1"] = (q[:1], bt[:1], torch.tensor([17], dtype=torch.int32,
                                                   device=dev), 0)
    cases["window"] = (q, bt, cl, 100)
    for name, (qq, tt, ll, win) in cases.items():
        got = DA.paged_decode_attention(qq, kp, vp, tt, ll, window=win)
        want = DA.paged_decode_attention_plain(qq, kp, vp, tt, ll, window=win)
        errs.append(max_err(got, want, f"paged_decode[{name}]"))
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
        f"tokens={tokens} checks={list(cases)} max_abs_err={max(errs):.3g} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f}")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:71",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "check": "pass", "checks": list(cases)}


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
    cases = {"causal": {}, "window": {"window": 200},
             "kv_len": {"causal": False, "kv_len": 700}}
    for name, kw in cases.items():
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        errs.append(max_err(got, want, f"flash[{name}]"))
    # a short non-tile-multiple prompt with a decode-style offset, and
    # ragged query and key lengths
    qs = q[:, :, :77]
    errs.append(max_err(FA.flash_attention(qs, k, v),
                        FA.flash_attention_plain(qs, k, v), "flash[offset]"))
    qr, kr, vr = q[:, :, :200], k[:, :, :200], v[:, :, :200]
    errs.append(max_err(FA.flash_attention(qr, kr, vr),
                        FA.flash_attention_plain(qr, kr, vr), "flash[ragged]"))
    ms = time_ms(lambda: FA.flash_attention(q, k, v), flush=flush)
    plain_ms = time_ms(lambda: FA.flash_attention_plain(q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush=flush)
    pairs = s * (s + 1) // 2                   # causal (q, k) pairs
    flops = 4 * b * h * pairs * d
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
    bound_ms, bound_by = max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
                             (flops / BF16_FLOPS_S * 1e3, "operations"))
    log(f"flash: B={b} H={h} V={vh} S={s} D={d} causal "
        f"checks={list(cases) + ['offset', 'ragged']} "
        f"max_abs_err={max(errs):.3g} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.5f}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:79",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "check": "pass", "checks": list(cases) + ["offset", "ragged"]}


# ---------------------------------------------------------------------------
# Phase 3: full-width engine
# ---------------------------------------------------------------------------


def engine_phase() -> dict:
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.core.memory_manager import merge_stacked
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.profile_engine import (PAGE_SIZE, TPOT_SLO_S,
                                                   smoke_engine,
                                                   smoke_requests)

    t0 = time.perf_counter()
    eng = smoke_engine()
    build_s = time.perf_counter() - t0
    cfg, page_size = eng.cfg, PAGE_SIZE
    rng = np.random.default_rng(0)
    reqs = smoke_requests(cfg.vocab_size, 16, rng)
    DA.launches = FA.launches = 0
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


def reference_phase() -> None:
    """The CUDA engine against the same engine on the CPU, which runs the
    kernels' plain versions: a small model, the same weights and the same
    trace, step by step. Scheduling decisions and iteration records must be
    equal, logits agree at the DualEngine tolerance, and on a numeric tie
    the CUDA engine is teacher-forced with the CPU engine's token."""
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
                        host_kv_bytes=32 * page_bytes)
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
    log(f"reference_lockstep: {len(gpu.finished)} finished, "
        f"{state['compares']} token compares, {state['ties']} ties, "
        f"max logit |err| {state['err']:.4g}, interval {gpu.interval}, "
        f"streamed pages peak {gpu.streamed_pages_peak}, "
        f"records {len(gpu.trace.iterations)} equal")
    if done[0] != done[1] or len(done[1]) != len(prompts):
        raise AssertionError("CUDA and CPU engines finished differently")
    if state["ties"] > max(1, 0.05 * state["compares"]):
        raise AssertionError(f"too many ties: {state['ties']}")
    if gpu.prefetch_copies <= 0 or gpu.streamed_pages_peak <= 0:
        raise AssertionError("the reference trace bypassed offloading")


def cli_phase() -> None:
    from repro_torch.launch import serve

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = serve.main(["--device", "cuda", "--hw", "h100", "--requests", "6",
                      "--host-kv-gb", "0.0001", "--metrics-out",
                      str(out_dir / "smoke_cli_trace.json")])
    if out["finished"] + out["rejected"] != 6 or out["finished"] == 0:
        raise AssertionError(f"serve CLI: {out['finished']} finished, "
                             f"{out['rejected']} rejected of 6")


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
    kernels = [check_decode(flush), check_flash(flush)]
    del flush
    log("kernels checked: " + json.dumps(
        {k["name"]: k["check"] for k in kernels}))

    launches = engine_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    reference_phase()
    cli_phase()

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
