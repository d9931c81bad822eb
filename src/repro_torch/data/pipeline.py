"""Deterministic synthetic request stream (port of the serving half of
``repro.data.pipeline``).

The paper's workload is a "randomly designed dataloader" (§5.1) — workload
content does not change the system's behaviour (deterministic layer times),
so a seeded stream is the faithful substrate. The training token stream is
ROADMAP Queue A item 10.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # synthetic request mix for serving benches
    mean_prompt_len: int = 256
    mean_output_len: int = 64


@dataclasses.dataclass(frozen=True)
class SyntheticRequest:
    rid: int
    prompt_len: int
    max_new_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    arrival_s: float


def request_stream(dcfg: DataConfig, n: int, *, ttft_slo_s: float,
                   tpot_slo_s: float, rate_per_s: float = 4.0
                   ) -> list[SyntheticRequest]:
    """Poisson arrivals with geometric lengths (paper §5.1 style)."""
    rng = np.random.Generator(np.random.Philox(key=dcfg.seed + 1))
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_per_s)
        out.append(SyntheticRequest(
            rid=i,
            prompt_len=int(np.clip(rng.geometric(
                1.0 / dcfg.mean_prompt_len), 8, 4096)),
            max_new_tokens=int(np.clip(rng.geometric(
                1.0 / dcfg.mean_output_len), 4, 1024)),
            ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s, arrival_s=t))
    return out
