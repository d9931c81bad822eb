"""Baselines the paper compares against (§3): DeepSpeed ZeRO-Inference,
(SLO-aware) FlexGen, and the naive no-offload mode. Used by the simulator
benchmarks and exposed as executable plans for the JAX path.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import HardwareModel
from repro_torch.core.interval import LayerTimes, NO_OFFLOAD, OffloadPlan


def naive_plan(num_units: int) -> OffloadPlan:
    return OffloadPlan(num_units, NO_OFFLOAD)


def deepspeed_plan(num_units: int) -> OffloadPlan:
    """Keep only the current layer on device — interval 1 (§3.2)."""
    return OffloadPlan(num_units, 1)


@dataclasses.dataclass(frozen=True)
class FlexGenDecision:
    fraction: float          # of every layer's weights offloaded to host
    est_iter_s: float        # its own (peak-FLOPs) latency estimate
    bw_fraction_assumed: float


def flexgen_decision(times: LayerTimes, hw: HardwareModel, slo_s: float,
                     layer_flops: float, n_bus_sharers: int = 1
                     ) -> FlexGenDecision:
    """The paper's SLO-aware FlexGen modification (§3.3): statically choose
    the largest offload fraction whose *estimated* latency meets the SLO.

    Two deliberate flaws reproduced from the paper's analysis:
      * compute time estimated from peak FLOPs (underestimates => conservative
        offloading, Observation #2);
      * bandwidth assumed to be 1/n of the link under contention
        (Observation #3).
    """
    bw_frac = 1.0 / max(1, n_bus_sharers)
    tc_est = hw.peak_exec_time(layer_flops)
    l = times.num_layers
    # One-layer-lookahead prefetch: per-layer latency = max(tc, f*tt/bw).
    # Feasibility: L * max(tc_est, f * tt / bw_frac) <= slo.
    per_layer_budget = slo_s / l
    if tc_est > per_layer_budget:
        frac = 0.0
    else:
        tt_eff = times.t_transfer_s / bw_frac
        frac = min(1.0, per_layer_budget / tt_eff) if tt_eff > 0 else 1.0
    est = l * max(tc_est, frac * times.t_transfer_s / bw_frac)
    return FlexGenDecision(fraction=frac, est_iter_s=est,
                           bw_fraction_assumed=bw_frac)


def flexgen_host_bytes(times: LayerTimes, decision: FlexGenDecision) -> float:
    return decision.fraction * times.num_layers * times.layer_bytes


def flexgen_equivalent_interval(times: LayerTimes,
                                decision: FlexGenDecision) -> int:
    """Interval with the same offloaded byte volume (for the JAX path)."""
    if decision.fraction <= 0:
        return NO_OFFLOAD
    n_off = max(1, int(round(decision.fraction * times.num_layers)))
    return max(1, times.num_layers // n_off)
