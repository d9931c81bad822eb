"""Interleaved A/B timing of paged decode kernel sources on one card.

Builds each ``--source label=path`` (a ``decode_attention.cu``: the
checkout's, a parent commit's unpacked with ``git archive``, a variant)
into a library of its own, launches each through this checkout's wrapper
(``decode_attention.paged_decode_attention_cuda``) on the same inputs, and

- checks that every source gives the same bits as the first at each case
  both accept (a ``--pow2-only`` source is not run at head_dim 120);
- times them at chip_smoke's three decode rows (D 128, D 256 and
  h2o-danube-3-4b's D 120, each a layer slice of a strided pool), the L2
  cache overwritten between calls, in ``ROUNDS`` rounds whose order
  turns (A B C, then C B A), so a drift of the card's clock falls on
  every source alike.

Prints, per row, each source's median over rounds of its per-round median
and, per source after the first, the median, least and greatest of its
per-round ratio to the first; the last line is one JSON object of the
same. Needs one card and ``nvcc``:

    PYTHONPATH=src python -m repro_torch.kernels.ab_decode \\
        --source new=src/repro_torch/kernels/csrc/decode_attention.cu \\
        --source parent=parent/src/repro_torch/kernels/csrc/decode_attention.cu \\
        --pow2-only parent
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as DA

# the rows' shapes: chip_smoke's check_decode (D 128), check_d256's decode
# (gemma-2b), check_d120 (h2o-danube-3-4b): batch, heads, KV heads, D,
# layers of the pool, the layer read, and the context lengths (None:
# random in 1 .. 1024, as chip_smoke draws them)
ROWS = {"d128": (8, 16, 2, 128, 36, 17, None),
        "d256": (8, 8, 1, 256, 18, 9, [527, 314, 141, 78, 495, 215, 48, 32]),
        "d120": (8, 32, 8, 120, 24, 11, None)}
PAGE, NB = 16, 64
# timing rounds, and L2-flushed launches a round (their median is the
# round's reading)
ROUNDS, ITERS = 30, 25
# further cases for the bit comparison alone: (batch, heads, KV heads, D,
# table pages, window)
BIT_CASES = [(5, 16, 4, 64, 12, 50), (3, 8, 2, 32, 9, 0), (4, 4, 1, 16, 7, 0),
             (2, 8, 8, 8, 5, 3), (8, 48, 8, 128, 64, 0), (8, 32, 8, 120, 64, 40),
             (3, 8, 1, 120, 9, 0), (8, 16, 2, 128, 64, 100)]


def build(label: str, path: Path):
    """``path`` compiled with the wrapper's flags into its own library;
    returns its launch function."""
    src = path.read_bytes()
    digest = hashlib.sha1(src + " ".join(_build.NVCC_FLAGS).encode()) \
        .hexdigest()[:12]
    out = _build.BUILD_DIR / f"libab_{label}_{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(path)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}"
                               f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    if lib.paged_decode_pages_per_split() != DA.PAGES_PER_SPLIT:
        raise RuntimeError(f"{path} splits KV differently from the wrapper")
    fn = lib.paged_decode_attention_bf16
    fn.argtypes, fn.restype = DA._ARGTYPES, ctypes.c_int
    return fn


def call(fn, q, kp, vp, bt, cl, window=0):
    """One launch of library ``fn`` through the checkout's wrapper."""
    saved, DA._launch_fn = DA._launch_fn, fn
    try:
        return DA.paged_decode_attention_cuda(q, kp, vp, bt, cl,
                                              window=window)
    finally:
        DA._launch_fn = saved


def inputs(gen, b, h, vh, d, layers, layer, cls, nb=NB):
    dev = torch.device("cuda")
    frames = 2 * b * nb + 1
    pool = torch.randn((frames, PAGE, layers, 2, vh, d), generator=gen,
                       device=dev).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    bt = torch.randperm(frames - 1, generator=gen, device=dev)[:b * nb] \
        .reshape(b, nb).to(torch.int32)
    cl = (torch.randint(1, nb * PAGE + 1, (b,), generator=gen, device=dev,
                        dtype=torch.int32) if cls is None
          else torch.tensor(cls, dtype=torch.int32, device=dev))
    return q, pool[:, :, layer, 0], pool[:, :, layer, 1], bt, cl


def launch_ms(fn, args, flush, iters: int) -> float:
    """Median of ``iters`` single launches (CUDA events), L2 overwritten
    before each."""
    call(fn, *args)
    times = []
    for _ in range(iters):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(fn, *args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", required=True,
                    help="label=path of a decode_attention.cu (first: the "
                         "one the others are held to)")
    ap.add_argument("--pow2-only", action="append", default=[],
                    help="a label whose source lacks head_dim 120")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_decode needs a CUDA device")
    labels, fns = [], {}
    for spec in args.source:
        label, path = spec.split("=", 1)
        labels.append(label)
        fns[label] = build(label, Path(path))
    takes = lambda label, d: d != 120 or label not in args.pow2_only
    gen = torch.Generator("cuda").manual_seed(0)

    bits = []
    for b, h, vh, d, nb, window in BIT_CASES:
        q, kp, vp, bt, cl = inputs(gen, b, h, vh, d, 4, 1, None, nb)
        outs = {lb: call(fns[lb], q, kp, vp, bt, cl, window)
                for lb in labels if takes(lb, d)}
        first = next(iter(outs.values()))
        same = all(torch.equal(first, o) for o in outs.values())
        bits.append({"case": [b, h, vh, d, nb, window], "sources":
                     list(outs), "bitwise": same})
        print(f"bits B={b} H={h} V={vh} D={d} nb={nb} window={window}: "
              f"{list(outs)} bitwise {same}", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, (b, h, vh, d, layers, layer, cls) in ROWS.items():
        a = inputs(gen, b, h, vh, d, layers, layer, cls)
        runs = [lb for lb in labels if takes(lb, d)]
        for lb in runs:
            want = call(fns[runs[0]], *a)
            if not torch.equal(call(fns[lb], *a), want):
                bits.append({"case": name, "sources": [runs[0], lb],
                             "bitwise": False})
        per = {lb: [] for lb in runs}
        for r in range(ROUNDS):
            for lb in (runs if r % 2 == 0 else runs[::-1]):
                per[lb].append(launch_ms(fns[lb], a, flush, ITERS))
        row = {"shape": f"B={b} H={h} V={vh} D={d} page={PAGE} nb={NB} "
                        f"tokens={int(a[4].sum())}",
               "median_ms": {lb: statistics.median(t)
                             for lb, t in per.items()}}
        for lb in runs[1:]:
            ratio = [x / y for x, y in zip(per[lb], per[runs[0]])]
            row[f"{lb}_over_{runs[0]}"] = {
                "median": statistics.median(ratio), "min": min(ratio),
                "max": max(ratio)}
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    ok = all(c["bitwise"] for c in bits)
    print(json.dumps({"rounds": ROUNDS, "iters": ITERS,
                      "bitwise": ok, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
