"""Latency SLO types (§2.2): TTFT for prefill, TPOT for decode."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLO:
    """A latency target in seconds for one phase."""
    kind: str           # "ttft" | "tpot"
    target_s: float

    def scaled(self, factor: float) -> "SLO":
        return SLO(self.kind, self.target_s * factor)


@dataclasses.dataclass(frozen=True)
class RequestSLO:
    ttft_s: float
    tpot_s: float

    @property
    def ttft(self) -> SLO:
        return SLO("ttft", self.ttft_s)

    @property
    def tpot(self) -> SLO:
        return SLO("tpot", self.tpot_s)


# The paper's record granularity: SLOs are bucketed at 2 ms (§4.4).
SLO_GRANULARITY_S = 0.002


def bucket_slo(target_s: float) -> float:
    """Round DOWN to the grid (conservative: never assume more slack)."""
    return int(target_s / SLO_GRANULARITY_S) * SLO_GRANULARITY_S
