"""The one traffic generator: a mix is a data file of parameters
(``bench/traffic/<mix>.json``) that this module reads.

Keys of a mix:

- ``loop``: ``"open"`` (requests sent on a schedule, whatever the system
  does) or ``"closed"`` (``clients`` callers, each sending its next request
  as soon as the last one has finished).
- ``rate_per_s`` (open loop): the mean arrival rate of a Poisson process.
- ``prompt`` and ``output``: ``median``, ``sigma``, ``min``, ``max`` of a
  clipped lognormal of token counts.
- ``block``: how many requests share one stratified set of sizes and gaps.
- ``max_seq``, ``max_batch``: the engine's sequence budget and slots.
- ``ttft_slo_s``, ``tpot_slo_s``: the SLOs each request is sent with.
- ``warmup_s``, ``warmup_max_s``: the warm-up serves this traffic for at
  least ``warmup_s`` seconds, until (an open loop) no request waits, and at
  most ``warmup_max_s`` seconds; then the window opens.
- ``drain_s``: how long after the window closes the run waits for the
  requests due in it.
- ``source``, ``assumed``, ``why``: where the sizes and arrivals come
  from, what the source does not state and was assumed, and what the mix
  exercises (read by no code).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from bench.common import workload

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


@dataclasses.dataclass
class Spec:
    """One request: its tokens, budget and SLOs, and for an open loop the
    second after the start of the traffic at which it is due."""
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    due_s: float | None


def load_mix(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    mix = json.loads((directory / f"{name}.json").read_text())
    mix["name"] = name
    return mix


def request_count(mix: dict, seconds: float) -> int:
    """Requests a run may send: the open loop's schedule over the warm-up,
    the window and the drain, with room; the closed loop's up to one
    completion per client every second."""
    span = mix["warmup_max_s"] + seconds + mix["drain_s"]
    if mix["loop"] == "open":
        return int(mix["rate_per_s"] * span * 1.5) + mix["block"]
    return int(mix["clients"] * span) + mix["block"]


def generate(mix: dict, seed: int, vocab: int, n: int) -> list[Spec]:
    """``n`` requests of ``mix`` from ``seed``: the same sizes (and, in an
    open loop, the same gaps) block by block for every seed, in the seed's
    order, with the seed's token contents."""
    rng = np.random.Generator(np.random.Philox(key=seed))
    b = mix["block"]
    p, o = mix["prompt"], mix["output"]
    plens = workload.blocks(workload.lognormal_lengths(
        p["median"], p["sigma"], p["min"], p["max"], b), n, rng)
    olens = workload.blocks(workload.lognormal_lengths(
        o["median"], o["sigma"], o["min"], o["max"], b), n, rng)
    if mix["loop"] == "open":
        gaps = workload.blocks(workload.exponential_gaps(
            mix["rate_per_s"], b), n, rng)
        due = np.cumsum(gaps)
    else:
        due = [None] * n
    return [Spec(i, rng.integers(0, vocab, int(pl)).astype(np.int32),
                 int(ol), mix["ttft_slo_s"], mix["tpot_slo_s"],
                 None if d is None else float(d))
            for i, (pl, ol, d) in enumerate(zip(plens, olens, due))]
