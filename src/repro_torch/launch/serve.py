"""End-to-end serving driver on one device: SLO-aware engine with Select-N
offloading (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --arch qwen2.5-3b --requests 12 --tpot-slo-ms 60 --hbm-gb 0.05

Builds the offline performance record (the analyzer's two-stage step 1),
starts an engine on ``--device`` (default cuda), replays a synthetic
request stream, and reports SLO attainment + throughput with the
reference's summary keys. ``--prefill-chunk-tokens N --incremental-prefill``
serves long prompts in chunks through the paged chunk-prefill kernel. Flags
of paths not ported yet exit with an error that names their ROADMAP item:
``--fleet``/``--peer``/``--disagg`` (and the fleet's ``--router``/
``--prefill-instances``/``--decode-instances``),
``--disk-kv-gb``/``--disk-backing-path`` and ``--async-data-plane``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduce_config
from repro_torch.core.analyzer import PerformanceAnalyzer
from repro_torch.core.hardware import PRESETS
from repro_torch.data.pipeline import DataConfig, request_stream
from repro_torch.data.workload import SLOClass, WorkloadConfig, generate_workload
from repro_torch.models.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request


def build_engine(name: str, cfg, hw, ecfg: EngineConfig,
                 slo_grid_s, measure: str = "model", device: str = "cuda",
                 params: dict | None = None) -> ServingEngine:
    model = build_model(cfg)
    an = PerformanceAnalyzer(cfg, hw, measure=measure)
    batches = [1, 2, 4, 8, 16, 32, 64, 128]
    seqs = [16, 32, 64, 128, 256, 512, 1024]
    batches = [b for b in batches if b <= ecfg.max_batch * 2]
    seqs = [s for s in seqs if s <= max(ecfg.max_seq * 2, 32)]
    rec_p = an.generate_record(slo_grid_s, batches, seqs, "prefill")
    rec_d = an.generate_record(slo_grid_s, batches, seqs, "decode")
    return ServingEngine(name, model, hw, rec_p, rec_d, an.layer_times, ecfg,
                         device=device, params=params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the model computes on (cuda, or cpu "
                         "to run the kernels' plain versions)")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--hw", default="a10", choices=list(PRESETS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--ttft-slo-ms", type=float, default=500.0)
    ap.add_argument("--tpot-slo-ms", type=float, default=100.0)
    ap.add_argument("--hbm-gb", type=float, default=0.05)
    ap.add_argument("--host-kv-gb", type=float, default=0.0,
                    help="pinned-host KV pool (two-tier KV offloading); "
                         "0 disables the host tier")
    ap.add_argument("--disk-kv-gb", type=float, default=0.0,
                    help="NVMe (disk) KV tier below the host pool: parked "
                         "requests and aged-out prefix-cache frames retire "
                         "here under host pressure; 0 disables the tier")
    ap.add_argument("--disk-bw-gbps", type=float, default=3.0,
                    help="disk link bandwidth in GB/s (its traffic gets "
                         "its own term in the SLO latency model)")
    ap.add_argument("--disk-backing-path", default=None,
                    help="file path for the disk pool (np.memmap); default "
                         "keeps a RAM buffer standing in for NVMe")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (the paged decode kernel's "
                         "block granularity)")
    ap.add_argument("--prefix-dedup", action="store_true",
                    help="content-address prompt pages across requests: "
                         "shared prefixes map onto the same physical frames "
                         "(refcounted, copy-on-write)")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="fraction of the prompt budget drawn from one "
                         "common prefix (chat-style system prompt; what "
                         "--prefix-dedup deduplicates)")
    ap.add_argument("--preemption", action="store_true",
                    help="preempt-to-host: park an active victim's whole KV "
                         "on the host tier when a queued request cannot be "
                         "admitted (wait-only otherwise)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="chunked prefill: scatter long prompts in "
                         "page-aligned chunks of this many tokens, "
                         "piggybacked on decode iterations (0 = one-shot "
                         "prefill at admission)")
    ap.add_argument("--async-data-plane", action="store_true",
                    help="double-buffered copy-stage engine: stage "
                         "iteration i+1's physical page copies (park legs, "
                         "disk retirements, resume promotions, resume "
                         "prefetch) while iteration i decodes, draining at "
                         "iteration boundaries (default: synchronous "
                         "copies inside the issuing iteration)")
    ap.add_argument("--incremental-prefill", action="store_true",
                    help="chunked prefills attend only the new chunk's "
                         "queries against resident paged KV instead of "
                         "recomputing the whole prefix per chunk (requires "
                         "--prefill-chunk-tokens; incompatible with "
                         "--prefix-dedup)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="mean arrival rate in requests/s on the modeled "
                         "clock. Arrivals are HONORED: a request stays "
                         "invisible to the scheduler until the clock "
                         "reaches its arrival_s (see --submit-all)")
    ap.add_argument("--arrival-process", choices=["poisson", "diurnal"],
                    default="poisson",
                    help="arrival process shape; 'diurnal' modulates the "
                         "rate sinusoidally (nonhomogeneous Poisson)")
    ap.add_argument("--workload", choices=["stream", "chat"],
                    default="stream",
                    help="request source: 'stream' = i.i.d. Poisson "
                         "request_stream; 'chat' = multi-round session "
                         "generator (data.workload: growing shared context "
                         "feeding prefix dedup, mixed SLO classes, "
                         "long-tail prompts)")
    ap.add_argument("--diurnal-period-s", type=float, default=60.0,
                    help="period of the diurnal rate modulation")
    ap.add_argument("--submit-all", action="store_true",
                    help="compat path: replay the whole trace as a burst at "
                         "clock 0 instead of honoring arrival_s")
    ap.add_argument("--autotune", action="store_true",
                    help="online interval autotuning (the paper's §5 online "
                         "stage): re-pick the offloading interval every "
                         "iteration inside the offline record's feasible "
                         "range from runtime gauges, lifting host-ward "
                         "when TPOT headroom allows and retreating before "
                         "a predicted violation")
    ap.add_argument("--peer", action="store_true",
                    help="second engine on the same host link (coordinator)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="number of independent serving instances; > 1 "
                         "starts a Fleet with a Router placing each arrival "
                         "by claimed prefix hits, queue depth and link "
                         "pressure, cross-instance preemption migrating "
                         "parked requests off overloaded instances, and "
                         "the fleet-wide link-budget coordinator")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode fleet: prompts route "
                         "to prefill-role instances, completed prefills "
                         "hand their KV off through the PEER tier to a "
                         "decode-role instance that certified the transfer "
                         "against its live TPOT budgets; TTFT is charged on "
                         "the prefill side, TPOT-plus-transfer on the "
                         "decode side")
    ap.add_argument("--prefill-instances", type=int, default=1,
                    help="prefill-role instance count (--disagg)")
    ap.add_argument("--decode-instances", type=int, default=1,
                    help="decode-role instance count (--disagg)")
    ap.add_argument("--router", choices=["affinity", "round_robin"],
                    default="affinity",
                    help="fleet placement policy (--fleet > 1): 'affinity' "
                         "scores prefix hits + load + link pressure; "
                         "'round_robin' is the byte-traffic baseline")
    ap.add_argument("--trace-out", default=None,
                    help="write the iteration trace as Chrome trace-event "
                         "JSON (load in Perfetto / chrome://tracing); also "
                         "runs the conservation auditor and exits nonzero "
                         "on any invariant violation")
    ap.add_argument("--metrics-out", default=None,
                    help="write the full structured trace (repro-trace/v1 "
                         "schema: per-iteration records, request events, "
                         "counter footer, audit report) as JSON")
    args = ap.parse_args(argv)
    refused = [
        (args.fleet > 1 or args.router != "affinity", "--fleet/--router",
         "Queue A item 7 (fleet)"),
        (args.peer, "--peer", "Queue A item 7 (fleet and coordinator peers)"),
        (args.disagg or args.prefill_instances != 1
         or args.decode_instances != 1, "--disagg",
         "Queue A item 7 (disaggregated fleet)"),
        (args.disk_kv_gb > 0 or args.disk_backing_path is not None,
         "--disk-kv-gb", "Queue A item 6 (disk tier)"),
        (args.async_data_plane, "--async-data-plane",
         "Queue A item 6 (copy-stage data plane)"),
    ]
    for hit, flag, item in refused:
        if hit:
            ap.error(f"{flag} is not ported yet: ROADMAP {item}")
    if args.incremental_prefill and args.prefix_dedup:
        ap.error("--incremental-prefill is incompatible with "
                 "--prefix-dedup (shared prompt frames would need COW "
                 "inside the chunk kernel)")
    cfg = reduce_config(get_config(args.arch))
    hw = PRESETS[args.hw]
    ecfg = EngineConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                        hbm_budget_bytes=args.hbm_gb * 1e9,
                        host_kv_bytes=args.host_kv_gb * 1e9,
                        disk_kv_bytes=args.disk_kv_gb * 1e9,
                        disk_bw_bytes_s=args.disk_bw_gbps * 1e9,
                        disk_backing_path=args.disk_backing_path,
                        page_size=args.page_size,
                        prefix_dedup=args.prefix_dedup,
                        preemption=args.preemption,
                        prefill_chunk_tokens=args.prefill_chunk_tokens,
                        async_data_plane=args.async_data_plane,
                        incremental_prefill=args.incremental_prefill,
                        autotune=args.autotune)
    slos = [0.002 * k for k in range(1, 120)]
    eng = build_engine("e0", cfg, hw, ecfg, slos, device=args.device)

    ttft_slo = args.ttft_slo_ms / 1e3
    tpot_slo = args.tpot_slo_ms / 1e3
    if args.workload == "chat":
        wcfg = WorkloadConfig(
            seed=0, process=args.arrival_process,
            rate_per_s=args.arrival_rate,
            diurnal_period_s=args.diurnal_period_s,
            # think time between a session's rounds paces with the load so
            # multi-round sessions interleave instead of serializing the run
            mean_think_s=4.0 / args.arrival_rate,
            system_prompt_len=max(int(args.shared_prefix_frac
                                      * (args.max_seq // 2)), 8),
            median_turn_len=8, max_prompt_len=args.max_seq // 2,
            mean_output_len=6.0, max_output_len=args.max_seq // 4,
            vocab_size=cfg.vocab_size,
            slo_classes=(
                SLOClass("interactive", ttft_slo, tpot_slo, 0.5),
                SLOClass("standard", 2.5 * ttft_slo, 2.5 * tpot_slo, 0.35),
                SLOClass("batch", 10 * ttft_slo, 10 * tpot_slo, 0.15)))
        reqs = generate_workload(wcfg, args.requests)
    else:
        rng = np.random.default_rng(0)
        stream = request_stream(DataConfig(seed=0, mean_prompt_len=12,
                                           mean_output_len=8), args.requests,
                                ttft_slo_s=ttft_slo, tpot_slo_s=tpot_slo,
                                rate_per_s=args.arrival_rate)
        common = rng.integers(0, cfg.vocab_size,
                              int(args.shared_prefix_frac
                                  * (args.max_seq // 2))).astype(np.int32)

        def _prompt(plen: int) -> np.ndarray:
            rest = rng.integers(0, cfg.vocab_size,
                                max(plen - len(common), 0)).astype(np.int32)
            return np.concatenate([common[:plen], rest])

        reqs = [Request(rid=r.rid,
                        prompt=_prompt(min(r.prompt_len, args.max_seq // 2)),
                        max_new_tokens=min(r.max_new_tokens,
                                           args.max_seq // 4),
                        ttft_slo_s=r.ttft_slo_s, tpot_slo_s=r.tpot_slo_s,
                        arrival_s=r.arrival_s) for r in stream]

    out = eng.run(reqs, submit_all=args.submit_all)
    summary = {k: v for k, v in out.items() if k != "per_request"}
    summary["final_interval"] = (None if eng.interval >= 10**9
                                 else eng.interval)
    summary["host_kv_peak_pages"] = eng.host_kv_peak_pages
    summary["disk_kv_peak_pages"] = eng.disk_kv_peak_pages
    summary["kv_tiers"] = (1 + int(eng.kv.host.total_pages > 0)
                           + int(eng.kv.disk.total_pages > 0))
    summary["decode_path"] = "paged"     # single page pool + decode kernel
    summary["streamed_pages_peak"] = eng.streamed_pages_peak
    summary["prefix_dedup"] = args.prefix_dedup
    summary["device_pages_peak"] = eng.device_pages_peak
    summary["dedup_pages_reused"] = eng.kv.dedup_pages_reused
    summary["cow_events"] = eng.cow_events
    summary["scheduler"] = {"preemption": args.preemption,
                            "prefill_chunk_tokens": args.prefill_chunk_tokens}
    summary["data_plane"] = {"async": args.async_data_plane,
                             "incremental_prefill": args.incremental_prefill}
    summary["arrival"] = {"process": args.arrival_process,
                          "rate_per_s": args.arrival_rate,
                          "honored": not args.submit_all,
                          "workload": args.workload}
    summary["autotune_enabled"] = args.autotune
    # preemptions / resumes / chunked_prefill_iters / queue_delay_p99_s come
    # from engine.run (scheduler IterationOutcome stats) and are already in
    # the summary dict above
    report = None
    if args.trace_out or args.metrics_out:
        report = eng.trace.audit()
        summary["audit"] = {"ok": report.ok, "checks": report.checks,
                            "violations": report.violations[:20]}
        if args.trace_out:
            eng.trace.write_perfetto(args.trace_out)
        if args.metrics_out:
            eng.trace.write_trace(args.metrics_out, audit=report)
    print(json.dumps(summary, indent=1))
    if report is not None and not report.ok:
        raise SystemExit(3)
    return out


if __name__ == "__main__":
    main()
