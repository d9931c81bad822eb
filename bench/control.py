"""The readings a cell's ``check.limit`` is set from: the program's
served-token gaps and the control's, seed by seed, in one process.

    python3 bench/control.py --workload deepseek7b-chat \\
        --seeds 11 12 13 --seconds 15

For each seed the cell is served as ``bench/run.py`` serves it (weights
from the seed, the engine primed, the mix's warm-up cut to ``--warmup``
seconds, a window of ``--seconds`` at the cell's own load, the drain), the
engine is freed, and the same sample of finished requests is held against
the float32 reference twice: the program's served tokens (the lower
reading) and, at the same positions, the first token of the reference
computed with float8 weights (the control, the upper reading). One JSON
line per seed. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.common import check, serve, traffic  # noqa: E402


def readings(cell: dict, seed: int, seconds: float, warmup: float,
             device: str = "cuda") -> dict:
    cfg = serve.load_config(cell["config"])
    mix = dict(traffic.load_mix(cell["traffic"]), warmup_s=warmup,
               warmup_max_s=warmup)
    vocab = cfg["model"]["vocab_size"]
    eng, _ = serve.build_engine(cfg, mix, seed, device)
    serve.prime(eng, vocab, np.random.default_rng(seed))
    specs = traffic.generate(mix, seed, vocab,
                             traffic.request_count(mix, seconds))
    served = serve.serve(eng, mix, specs, seconds, time.perf_counter())
    del eng
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    lim = cfg["check"]
    picked = check.sample(served.tracked, seed, lim["min_tokens"],
                          lim["min_requests"])
    t = time.perf_counter()
    program = check.served_gap(cfg["model"], seed, picked, device)
    control = check.control_gap(cfg["model"], seed, picked, device)
    return {"workload": cell["name"], "seed": seed, "program": program,
            "control": control, "statistic": lim["statistic"],
            "limit": lim["limit"],
            "reference_s": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--warmup", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    for seed in args.seeds:
        out = readings(cell, seed, args.seconds, args.warmup)
        out["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
