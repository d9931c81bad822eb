"""Offline performance analyzer (§4.4), port of ``repro.core.analyzer``.

For every (batch, seq) bucket it obtains per-layer compute time plus the
layer transfer time, and tabulates the optimal offloading interval for every
SLO on the 2 ms grid. Only the "model" measurement mode is ported: an
analytic roofline estimate from the hardware preset (recorded in the
record's provenance field). The "wallclock" mode, which times one scan unit
on the device, and ``determinism_check`` are ROADMAP Queue A item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core.hardware import HardwareModel
from repro_torch.core.interval import LayerTimes, optimal_interval
from repro_torch.core.record import PerformanceRecord
from repro_torch.models import transformer as T


@dataclasses.dataclass
class MeasuredTimes:
    t_compute_s: float       # one scan unit (pattern period)
    t_transfer_s: float      # one scan unit's weights over the host link
    t_rest_s: float
    unit_bytes: int
    num_units: int


class PerformanceAnalyzer:
    def __init__(self, cfg: ModelConfig, hw: HardwareModel,
                 measure: str = "model", link_share: float = 1.0):
        if measure != "model":
            raise NotImplementedError(
                f"measure={measure!r}: wall-clock layer timing on the GPU is "
                "ROADMAP Queue A item 8; only measure='model' is ported")
        self.cfg = cfg
        self.hw = hw
        self.measure = measure
        self.link_share = link_share

    # ---- per-(batch, seq) measurement ---------------------------------------
    def measure_times(self, batch: int, seq: int, phase: str) -> MeasuredTimes:
        cfg = self.cfg
        p, r = T.pattern_info(cfg)
        unit_bytes = costs.unit_weight_bytes(cfg)
        # Per-device transferred bytes scale with the TP shard; the analyzer
        # works in whole-instance terms (every host moves its shard in
        # parallel), so full unit bytes over one link is the faithful unit.
        t_transfer = self.hw.transfer_time(unit_bytes, self.link_share)

        if phase == "prefill":
            fl = sum(costs.layer_flops(cfg, batch, seq, seq, j)
                     for j in range(p))
            by = sum(costs.layer_act_bytes(cfg, batch, seq, seq, j)
                     for j in range(p))
        else:
            fl = sum(costs.layer_flops(cfg, batch, 1, seq, j)
                     for j in range(p))
            by = sum(costs.layer_act_bytes(cfg, batch, 1, seq, j)
                     for j in range(p))
        t_compute = self.hw.exec_time(fl, by)
        rest = self.hw.exec_time(
            2 * batch * (seq if phase == "prefill" else 1)
            * cfg.d_model * cfg.padded_vocab(),
            cfg.padded_vocab() * cfg.d_model * 2)
        return MeasuredTimes(t_compute, t_transfer, rest, unit_bytes, r)

    def layer_times(self, batch: int, seq: int, phase: str) -> LayerTimes:
        mt = self.measure_times(batch, seq, phase)
        return LayerTimes(
            t_compute_s=mt.t_compute_s, t_transfer_s=mt.t_transfer_s,
            num_layers=mt.num_units, layer_bytes=mt.unit_bytes,
            t_rest_s=mt.t_rest_s)

    # ---- record generation ----------------------------------------------------
    def generate_record(self, slos_s: Sequence[float], batches: Sequence[int],
                        seqs: Sequence[int], phase: str) -> PerformanceRecord:
        rec = PerformanceRecord(
            model_name=self.cfg.name, hardware=self.hw.name, phase=phase,
            batches=sorted(batches), seqs=sorted(seqs), measure=self.measure)
        for b in rec.batches:
            for s in rec.seqs:
                times = self.layer_times(b, s, phase)
                for slo in slos_s:
                    rec.set(slo, b, s, optimal_interval(times, slo))
        return rec
