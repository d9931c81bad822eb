"""Serving request lifecycle."""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class State(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    # Preempt-to-host: the scheduler parked this request's entire KV on the
    # host tier to vacate device frames (and its streaming traffic) for a
    # blocked admission; it resumes decoding — token-exactly — once capacity
    # and the TPOT budget allow.
    PREEMPTED = "preempted"
    FINISHED = "finished"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [prompt_len] int32
    max_new_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    arrival_s: float = 0.0
    # multi-tenant traces: sessions of the same tenant share a per-tenant
    # system prefix, so same-tenant prompts carry identical leading
    # ``prefix_page_keys`` — the fleet router's affinity signal
    tenant: int = 0
    state: State = State.QUEUED
    # runtime
    slot: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    ttft_s: float | None = None
    tpot_s: list[float] = dataclasses.field(default_factory=list)
    reject_reason: str = ""
    # chunked prefill: tokens of the prompt whose KV has been computed and
    # scattered so far; TTFT accrues per chunk into ttft_accum_s until the
    # final chunk lands (prefill_pos == prompt_len) and sets ttft_s.
    prefill_pos: int = 0
    ttft_accum_s: float = 0.0
    # preempt-to-host resume snapshot: the sampled-but-not-yet-decoded token
    # and the write position, restored verbatim when the request is resumed.
    next_token: int = -1
    resume_pos: int = 0
    preempt_count: int = 0
    # modeled clock spent parked (inter-token stall the per-iteration TPOT
    # samples deliberately do NOT include — reported separately so a parked
    # request's starvation is visible, not hidden inside a passing tpot_ok)
    preempt_stall_s: float = 0.0
    parked_at_s: float | None = None
    # queueing-delay accounting (modeled clock)
    submitted_s: float | None = None
    admitted_s: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def queue_delay_s(self) -> float | None:
        if self.submitted_s is None or self.admitted_s is None:
            return None
        return self.admitted_s - self.submitted_s

    @property
    def ttft_e2e_s(self) -> float | None:
        """End-to-end first-token latency on the modeled clock: queueing
        delay (from the arrival process — ``engine.run`` stamps
        ``submitted_s = arrival_s`` when honoring arrivals) plus the prefill
        latency ``ttft_s``. The SLO check stays on ``ttft_s`` (the bound the
        scheduler certifies at admission); this is the user-visible number
        the sustained-load bench reports alongside it."""
        if self.queue_delay_s is None or self.ttft_s is None:
            return None
        return self.queue_delay_s + self.ttft_s

    def metrics(self) -> dict:
        tpot = float(np.mean(self.tpot_s)) if self.tpot_s else 0.0
        return {
            "rid": self.rid,
            "ttft_s": self.ttft_s,
            "tpot_mean_s": tpot,
            "tpot_p99_s": float(np.quantile(self.tpot_s, 0.99))
            if self.tpot_s else 0.0,
            "ttft_ok": self.ttft_s is not None and self.ttft_s
            <= self.ttft_slo_s * (1 + 1e-9),
            "tpot_ok": all(t <= self.tpot_slo_s * (1 + 1e-9)
                           for t in self.tpot_s),
            "tokens": len(self.generated),
            "preempts": self.preempt_count,
            "preempt_stall_s": self.preempt_stall_s,
            "queue_delay_s": self.queue_delay_s,
            "ttft_e2e_s": self.ttft_e2e_s,
        }
