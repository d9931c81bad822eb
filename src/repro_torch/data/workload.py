"""Trace-driven production workload generator (ROADMAP item 5).

The serving benches so far replayed 2-16 request bursts; this module emits
thousand-request traces with absolute ``arrival_s`` on the modeled clock so
the arrival-aware engine loop (``ServingEngine.run``) can hold each request
invisible to the scheduler until its arrival. Shapes modeled, after
production-stack's multi-round-qa exemplar:

  * **arrival processes** — homogeneous Poisson (exponential gaps) or
    diurnal (nonhomogeneous Poisson, rate ``lambda(t) = rate * (1 +
    diurnal_amplitude * sin(2*pi*t / diurnal_period_s))`` sampled by
    thinning);
  * **multi-round chat sessions** — a session opens with a system prompt
    shared across ALL sessions (what prefix dedup deduplicates) — or, with
    ``tenants > 1``, with its tenant's system prompt, shared across that
    tenant's sessions only — every round's prompt extends the session's own
    growing history prefix, and rounds are spaced by exponential think time;
  * **mixed SLO classes** — each session draws one ``(ttft_slo_s,
    tpot_slo_s)`` class (interactive / standard / batch style) with
    configurable weights;
  * **long-tail prompt lengths** — lognormal per-round user turns, clipped
    to the engine's sequence budget.

Determinism: everything derives from one Philox counter-based generator
keyed on ``seed`` (the ``data.pipeline`` convention), so trace N is
reproducible from its config alone. The output is a flat,
arrival-sorted ``list[Request]`` — ``repro_torch.serving.request.Request`` is a
plain dataclass, so this stays importable without JAX compile machinery.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class SLOClass:
    name: str
    ttft_slo_s: float
    tpot_slo_s: float
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    seed: int = 0
    # arrival process
    process: str = "poisson"            # "poisson" | "diurnal"
    rate_per_s: float = 4.0             # mean arrival rate (sessions/s)
    diurnal_amplitude: float = 0.5      # peak-to-mean swing, in [0, 1)
    diurnal_period_s: float = 60.0
    # session shape
    mean_rounds: float = 3.0            # geometric number of chat rounds
    mean_think_s: float = 1.0           # exponential gap between rounds
    system_prompt_len: int = 32         # shared across every session
    # multi-tenant traces: with tenants > 1 each session draws a tenant id
    # uniformly and opens with that TENANT's system prompt instead of the
    # global one, so same-tenant sessions share identical leading
    # ``prefix_page_keys`` (the fleet router's affinity signal) while
    # different tenants diverge from page 0. tenants == 1 keeps the legacy
    # single shared prompt and makes no extra RNG draws (bitwise-identical
    # traces for every existing config).
    tenants: int = 1
    # per-round user turn: lognormal long tail, clipped to max_prompt_len
    median_turn_len: int = 24
    turn_len_sigma: float = 0.8
    max_prompt_len: int = 512           # cap on the full (history) prompt
    mean_output_len: float = 16.0       # geometric decode budget per round
    max_output_len: int = 256
    vocab_size: int = 128
    slo_classes: tuple[SLOClass, ...] = (
        SLOClass("interactive", ttft_slo_s=0.2, tpot_slo_s=0.04, weight=0.5),
        SLOClass("standard", ttft_slo_s=0.5, tpot_slo_s=0.1, weight=0.35),
        SLOClass("batch", ttft_slo_s=2.0, tpot_slo_s=0.5, weight=0.15),
    )


def _session_arrivals(rng: np.random.Generator, cfg: WorkloadConfig,
                      n: int) -> list[float]:
    """Arrival time of each session's FIRST round."""
    if cfg.process == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate_per_s, size=n)
        return list(np.cumsum(gaps))
    if cfg.process != "diurnal":
        raise ValueError(f"unknown arrival process {cfg.process!r}")
    # thinning of a nonhomogeneous Poisson process: propose at the peak
    # rate, accept with probability lambda(t)/lambda_max
    lam_max = cfg.rate_per_s * (1.0 + cfg.diurnal_amplitude)
    out: list[float] = []
    t = 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = cfg.rate_per_s * (1.0 + cfg.diurnal_amplitude
                                  * math.sin(2 * math.pi * t
                                             / cfg.diurnal_period_s))
        if rng.random() * lam_max <= lam_t:
            out.append(t)
    return out


def generate_workload(cfg: WorkloadConfig, n_requests: int) -> list[Request]:
    """Emit ``n_requests`` requests (across as many sessions as needed),
    sorted by ``arrival_s``. Round k of a session carries the session's full
    accumulated context — system prompt + every earlier round's tokens — as
    a growing shared prefix, which is exactly what ``--prefix-dedup``
    content-addresses."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed))
    system = rng.integers(0, cfg.vocab_size, cfg.system_prompt_len
                          ).astype(np.int32)
    # per-tenant system prompts (tenant 0 keeps the legacy draw above, so a
    # tenants=1 config reproduces pre-tenant traces bitwise)
    tenant_systems = [system]
    for _ in range(1, max(cfg.tenants, 1)):
        tenant_systems.append(rng.integers(0, cfg.vocab_size,
                                           cfg.system_prompt_len
                                           ).astype(np.int32))
    starts = _session_arrivals(rng, cfg, n_requests)  # upper bound: >=1/sess
    reqs: list[Request] = []
    rid = 0
    for t0 in starts:
        if rid >= n_requests:
            break
        rounds = int(rng.geometric(1.0 / max(cfg.mean_rounds, 1.0)))
        tenant = int(rng.integers(0, cfg.tenants)) if cfg.tenants > 1 else 0
        history = tenant_systems[tenant]
        t = t0
        cls = rng.choice(len(cfg.slo_classes),
                         p=_weights(cfg.slo_classes))
        slo = cfg.slo_classes[int(cls)]
        for _ in range(rounds):
            if rid >= n_requests:
                break
            turn_len = int(np.clip(
                rng.lognormal(math.log(max(cfg.median_turn_len, 1)),
                              cfg.turn_len_sigma), 1, cfg.max_prompt_len))
            turn = rng.integers(0, cfg.vocab_size, turn_len).astype(np.int32)
            prompt = np.concatenate([history, turn])[-cfg.max_prompt_len:]
            new = int(np.clip(rng.geometric(1.0 / cfg.mean_output_len),
                              1, cfg.max_output_len))
            reqs.append(Request(rid=rid, prompt=prompt, max_new_tokens=new,
                                ttft_slo_s=slo.ttft_slo_s,
                                tpot_slo_s=slo.tpot_slo_s, arrival_s=t,
                                tenant=tenant))
            rid += 1
            # the next round's history includes this round's turn (the
            # modeled reply tokens are not knowable at trace time; the
            # growing user-side context is what feeds dedup)
            history = prompt
            t += rng.exponential(cfg.mean_think_s)
    reqs.sort(key=lambda r: r.arrival_s)
    for i, r in enumerate(reqs):
        r.rid = i                      # rids follow arrival order
    return reqs


def _weights(classes: tuple[SLOClass, ...]) -> np.ndarray:
    w = np.asarray([c.weight for c in classes], np.float64)
    return w / w.sum()
