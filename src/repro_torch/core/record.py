"""Performance record (§4.4, Table 1).

For each phase (prefill/decode) and SLO bucket (2 ms grid), a table over
(batch, seq) power-of-two buckets storing the optimal (smallest feasible)
offloading interval. Lookups round batch/seq *down* and SLO *down* — both
conservative: assuming less compute-cover and less slack can only produce a
larger (safer) interval.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.interval import NO_OFFLOAD
from repro_torch.core.slo import SLO_GRANULARITY_S, bucket_slo


@dataclasses.dataclass
class PerformanceRecord:
    model_name: str
    hardware: str
    phase: str                      # "prefill" | "decode"
    batches: list[int]              # ascending, powers of two
    seqs: list[int]                 # ascending, powers of two
    # table[slo_bucket_key][bi][si] -> interval
    table: dict[int, list[list[int]]] = dataclasses.field(default_factory=dict)
    # provenance: measured wall-clock or analytic model
    measure: str = "wallclock"

    @staticmethod
    def slo_key(slo_s: float) -> int:
        return int(round(bucket_slo(slo_s) / SLO_GRANULARITY_S))

    def set(self, slo_s: float, batch: int, seq: int, interval: int) -> None:
        k = self.slo_key(slo_s)
        if k not in self.table:
            self.table[k] = [[NO_OFFLOAD] * len(self.seqs)
                             for _ in self.batches]
        bi = self.batches.index(batch)
        si = self.seqs.index(seq)
        self.table[k][bi][si] = interval

    def _bucket_down(self, grid: list[int], v: int) -> int | None:
        idx = None
        for i, g in enumerate(grid):
            if g <= v:
                idx = i
        return idx

    def lookup(self, slo_s: float, batch: int, seq: int) -> int:
        """Optimal interval, conservatively bucketed. NO_OFFLOAD if the SLO
        admits no offloading (or is below any recorded bucket)."""
        keys = sorted(self.table)
        k = self.slo_key(slo_s)
        avail = [x for x in keys if x <= k]
        if not avail:
            return NO_OFFLOAD
        key = avail[-1]
        bi = self._bucket_down(self.batches, batch)
        si = self._bucket_down(self.seqs, seq)
        if bi is None or si is None:
            bi = bi if bi is not None else 0
            si = si if si is not None else 0
        return self.table[key][bi][si]

    # ---- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "model_name": self.model_name, "hardware": self.hardware,
            "phase": self.phase, "batches": self.batches, "seqs": self.seqs,
            "measure": self.measure,
            "table": {str(k): v for k, v in self.table.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "PerformanceRecord":
        d = json.loads(s)
        rec = cls(model_name=d["model_name"], hardware=d["hardware"],
                  phase=d["phase"], batches=d["batches"], seqs=d["seqs"],
                  measure=d.get("measure", "wallclock"))
        rec.table = {int(k): v for k, v in d["table"].items()}
        return rec

    def render(self, slo_s: float) -> str:
        """Pretty-print one SLO's table (paper Table 1 style)."""
        k = self.slo_key(slo_s)
        if k not in self.table:
            return "(no record for this SLO)"
        rows = [" b\\s | " + " ".join(f"{s:>6d}" for s in self.seqs)]
        rows.append("-" * len(rows[0]))
        for bi, b in enumerate(self.batches):
            cells = " ".join(
                f"{'inf' if v >= NO_OFFLOAD else v:>6}" for v in self.table[k][bi])
            rows.append(f"{b:>4d} | {cells}")
        return "\n".join(rows)
