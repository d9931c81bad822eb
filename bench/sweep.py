"""The knee sweep of an open-loop cell: the highest arrival rate the system
serves without a growing backlog.

    python3 bench/sweep.py --workload deepseek7b-chat --seed 3 \\
        --rates 0.8 1.2 1.6 2.0 --seconds 30

One process builds the cell's engine once and serves the cell's mix at each
rate in turn (its warm-up, a window of ``--seconds``, the drain), with the
engine emptied between rates. For each rate it prints one JSON line: the
end-to-end metrics of the window, the requests waiting in the scheduler's
queue when the window opened and when it closed, and the requests due in
the window that had not started when it closed. A backlog grows where the
queue at the close is well above the queue at the open and keeps rising
with the rate. The cell's rate is then set in its mix's file, at about four
fifths of the knee.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.common import metrics, serve, traffic  # noqa: E402
from bench.common.metrics import Run  # noqa: E402


def drain(eng) -> None:
    while eng.scheduler.has_work() or eng._active_batch() > 0:
        eng.step()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = serve.load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    if mix["loop"] != "open":
        print("a closed loop has no rate to sweep", file=sys.stderr)
        return 2
    vocab = cfg["model"]["vocab_size"]
    eng, _ = serve.build_engine(cfg, mix, args.seed, "cuda")
    serve.prime(eng, vocab, np.random.default_rng(args.seed))
    entries = metrics.cell_entries(bench, cell["name"], "end_to_end")
    for i, rate in enumerate(args.rates):
        m = dict(mix, rate_per_s=rate)
        specs = traffic.generate(m, args.seed + i, vocab,
                                 traffic.request_count(m, args.seconds))
        served = serve.serve(eng, m, specs, args.seconds, T_PROCESS)
        run = Run(cfg, m, served)
        vals = metrics.read_all(entries, run)
        window = run.window
        at_close = [t for t in window if t.admitted is None
                    or t.admitted > served.t1]

        def waiting(at: float, served=served) -> int:
            """Requests submitted by ``at`` and not yet admitted."""
            return sum(1 for t in served.tracked
                       if t.submitted is not None and t.submitted <= at
                       and (t.admitted is None or t.admitted > at))

        print(json.dumps({
            "rate_per_s": rate, "due_in_window": len(window),
            "failed": sum(1 for t in window if t.failed),
            "waiting_at_open": waiting(served.t0),
            "waiting_at_close": waiting(served.t1),
            "not_started_at_close": len(at_close),
            "intervals_in_window": sorted({r.interval for r in
                                           run.window_steps}),
            "warmup_s": served.t0 - served.steps[0].start
            if served.steps else None,
            "metrics": {k: v["value"] for k, v in vals.items()
                        if k != "setup_s"},
            "card": torch.cuda.get_device_name(0)}), flush=True)
        drain(eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
