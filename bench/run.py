"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload deepseek7b-chat --seed 7 --seconds 51 \\
        --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<mix>.json``). The run makes the weights on the card from
``--seed``, builds the engine of ``repro_torch.serving.engine``, primes it,
serves the mix's warm-up and then a window of ``--seconds`` through
``ServingEngine.submit`` / ``step`` on the host's wall clock
(``bench/common/serve.py``), waits for the requests due in the window,
reads the cell's metrics (``bench/metrics/<name>.py``: the end-to-end ones
with ``--trace 0``, the per-layer ones with ``--trace 1``, which profiles
with ``torch.profiler`` the card's activity alone from the end of the
warm-up until the window has closed and its requests are admitted), frees
the engine, and holds a sample of the served tokens against the plain
reference (``bench/common/check.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and with ``--trace 1`` ``breakdown``), and last ``checks``, each
number compared beside its limit. Exits 2 without enough CUDA devices.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.common import check, metrics, serve, traffic, tracefile  # noqa
from bench.common.metrics import Run  # noqa: E402

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def read_trace(served) -> tracefile.Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        served.profiler.export_chrome_trace(path)
        with open(path) as f:
            return tracefile.Trace(json.load(f), served.host_spans,
                                   served.epoch_offset)
    finally:
        os.unlink(path)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t_process: float,
             config_dir: Path = serve.CONFIG_DIR,
             traffic_dir: Path = traffic.TRAFFIC_DIR) -> dict:
    cfg = serve.load_config(cell["config"], config_dir)
    mix = traffic.load_mix(cell["traffic"], traffic_dir)
    on_card = torch.device(device).type == "cuda"
    vocab = cfg["model"]["vocab_size"]
    eng, info = serve.build_engine(cfg, mix, seed, device)
    log(f"engine: {json.dumps(info)}")
    serve.prime(eng, vocab, np.random.default_rng(seed))
    specs = traffic.generate(mix, seed, vocab,
                             traffic.request_count(mix, seconds))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    served = serve.serve(eng, mix, specs, seconds, t_process,
                         profile=trace and on_card)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    late = sorted(served.lateness)
    intervals = sorted({r.interval for r in served.steps
                        if served.t0 <= r.end < served.t1})
    log(f"generator lateness s: n={len(late)} "
        f"median={late[len(late) // 2] if late else None} "
        f"max={late[-1] if late else None}")
    in_win = [r for r in served.steps if served.t0 <= r.end < served.t1]
    wsteps = sorted(r.end - r.start for r in in_win)
    log(f"window steps s: n={len(wsteps)} "
        f"median={wsteps[len(wsteps) // 2] if wsteps else None} "
        f"max={wsteps[-1] if wsteps else None} switches_in_window="
        f"{sum(a.interval != b.interval for a, b in zip(in_win, in_win[1:]))}")
    log(f"engine counters: intervals_in_window={intervals} "
        f"interval_switches={eng.interval_switches} "
        f"decode_graph_captures={eng.decode_graph_captures} "
        f"rejected={len(eng.rejected)} steps={len(served.steps)}")
    run = Run(cfg, mix, served)
    if served.profiler is not None:
        run.trace = read_trace(served)
        served.profiler = None
        log(f"trace: device busy inside bench.step spans "
            f"{run.trace.host_cover}")
    kind = "per_layer" if trace else "end_to_end"
    values = metrics.read_all(
        metrics.cell_entries(bench, cell["name"], kind), run)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"] if on_card else 1,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace is not None:
        steps = run.trace.annotations("bench.step")
        lo = min((s for s, _ in steps), default=0.0)
        hi = max((e for _, e in steps), default=0.0)
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = served.trace_window[1] - served.trace_window[0]
        breakdown = {"device_ops": run.trace.top_kernels(10),
                     "idle_gaps": run.trace.idle_gaps((lo, hi), 10)}
        run.trace = None
    window = [t for t in served.tracked if t.in_window]
    failed = sum(1 for t in window if t.failed)
    # the window has closed: free the engine before the reference runs
    del eng, run
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"card: {card()}")
    lim = cfg["check"]
    picked = check.sample(served.tracked, seed, lim["min_tokens"],
                          lim["min_requests"])
    t_ref = time.perf_counter()
    got = (check.served_gap(cfg["model"], seed, picked, device) if picked
           else None)
    log(f"reference: {json.dumps(got)} in "
        f"{time.perf_counter() - t_ref:.1f} s")
    stat = lim["statistic"]
    value = got[stat] if got else None
    served_tokens = sum(len(t.req.generated) for t in window if t.finished)
    checks = {stat: {"value": value, "limit": lim["limit"]},
              "served_tokens_compared": {
                  "value": got["tokens"] if got else 0,
                  "limit": min(lim["min_tokens"], served_tokens)}}
    correct = (value is not None and value <= lim["limit"]
               and checks["served_tokens_compared"]["value"]
               >= checks["served_tokens_compared"]["limit"])
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": failed, "metrics": values, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout (the
    # port's kernels build into src/repro_torch/kernels/build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "bench" / ".cache" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
