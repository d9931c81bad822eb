"""Per-bus bandwidth coordinator (§4.5, Fig. 8).

Multiple serving instances share a host link. Each has, for its current
request, a minimum interval (from the performance record — below it the SLO
breaks) and a maximum interval (from device memory — above it the resident
weights don't fit). The coordinator picks one interval per instance so that
the summed link rates stay under the link bandwidth while total host-memory
usage is maximal.

The paper presents the 2-instance enumeration; we generalize: exact product
search up to a size bound, greedy relaxation beyond (monotone: raising an
interval only lowers both link rate and host usage, so greedy-lift converges).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan


@dataclasses.dataclass
class InstanceState:
    name: str
    num_units: int
    unit_bytes: int
    t_iter_s: float          # current iteration latency (deterministic)
    min_interval: int        # from the performance record (SLO bound)
    max_interval: int        # from device memory (capacity bound)
    idle: bool = False       # idle instances consume no bandwidth
    # Per-iteration KV-page traffic (streamed host-resident KV + migrations,
    # both directions) of this instance's two-tier KV cache. It rides the
    # same host link as weight prefetch, so the coordinator must arbitrate
    # the combined rate (weights + KV) against the link bandwidth.
    kv_bytes_per_iter: float = 0.0
    # Pending peer-link handoff traffic (PEER tier, both directions). The
    # transfer itself has its own modeled link, but every handoff payload
    # crosses this instance's host memory system, so its rate is arbitrated
    # against the shared budget alongside weight prefetch and KV streams.
    peer_bytes_per_iter: float = 0.0

    def valid_intervals(self) -> list[int]:
        if self.idle:
            return [NO_OFFLOAD]
        top = min(self.max_interval, self.num_units)
        vals = [i for i in range(max(1, self.min_interval), top + 1)]
        if self.max_interval >= NO_OFFLOAD:
            vals.append(NO_OFFLOAD)
        # An empty range means no interval satisfies both the SLO bound
        # (min_interval) and the memory bound (max_interval). There is no
        # fallback: NO_OFFLOAD is only valid when the fully-resident weights
        # actually fit (max_interval >= NO_OFFLOAD, appended above).
        return vals

    def admissible(self) -> bool:
        """Paper Fig. 8 lines 34-35: SLO is meetable at all — some interval
        satisfies both the record's floor and the memory ceiling."""
        return self.idle or bool(self.valid_intervals())

    def link_rate(self, interval: int) -> float:
        if self.idle:
            return 0.0
        plan = OffloadPlan(self.num_units, interval)
        kv_rate = (self.kv_bytes_per_iter + self.peer_bytes_per_iter) \
            / self.t_iter_s if self.t_iter_s > 0 else 0.0
        return plan.link_rate(self.unit_bytes, self.t_iter_s) + kv_rate

    def host_bytes(self, interval: int) -> int:
        return OffloadPlan(self.num_units, interval).host_bytes(self.unit_bytes)


@dataclasses.dataclass
class CoordinationResult:
    ok: bool
    intervals: dict[str, int]
    total_host_bytes: int
    total_link_rate: float
    reason: str = ""


EXACT_SEARCH_LIMIT = 200_000


def coordinate(instances: Sequence[InstanceState], link_bw: float
               ) -> CoordinationResult:
    for inst in instances:
        if not inst.admissible():
            return CoordinationResult(
                False, {}, 0, 0.0,
                f"{inst.name}: min interval {inst.min_interval} exceeds max "
                f"{inst.max_interval}; return request to upper-level scheduler")

    choices = [inst.valid_intervals() for inst in instances]
    space = math.prod(len(c) for c in choices)

    def evaluate(combo: Sequence[int]):
        rate = sum(inst.link_rate(iv) for inst, iv in zip(instances, combo))
        host = sum(inst.host_bytes(iv) for inst, iv in zip(instances, combo))
        return rate, host

    if space <= EXACT_SEARCH_LIMIT:
        best = None
        for combo in itertools.product(*choices):
            rate, host = evaluate(combo)
            if rate <= link_bw and (best is None or host > best[0]):
                best = (host, rate, combo)
        if best is None:
            return CoordinationResult(False, {}, 0, 0.0,
                                      "no interval combination fits the link")
        host, rate, combo = best
        return CoordinationResult(
            True, {i.name: v for i, v in zip(instances, combo)}, host, rate)

    # Greedy: start from min intervals (max host memory), lift the interval
    # whose increase sheds the most bandwidth per host-byte sacrificed.
    combo = [c[0] for c in choices]
    idx = [0] * len(instances)
    rate, host = evaluate(combo)
    while rate > link_bw:
        best_j, best_score = -1, -1.0
        for j, inst in enumerate(instances):
            if idx[j] + 1 >= len(choices[j]):
                continue
            nxt = choices[j][idx[j] + 1]
            d_rate = inst.link_rate(combo[j]) - inst.link_rate(nxt)
            d_host = max(inst.host_bytes(combo[j]) - inst.host_bytes(nxt), 1)
            score = d_rate / d_host
            if score > best_score:
                best_j, best_score = j, score
        if best_j < 0:
            return CoordinationResult(False, {}, 0, 0.0,
                                      "greedy: cannot fit link bandwidth")
        idx[best_j] += 1
        combo[best_j] = choices[best_j][idx[best_j]]
        rate, host = evaluate(combo)
    return CoordinationResult(
        True, {i.name: v for i, v in zip(instances, combo)}, host, rate)


class FleetLinkBudget:
    """Fleet-wide owner of the shared host-link budget (the bus arbiter
    promoted to fleet scope). One object per fleet holds the link bandwidth;
    the fleet's step loop asks it to ``certify`` the instance set (the same
    §4.5 arbitration ``coordinate`` runs per bus), and the affinity router
    asks it for per-instance ``pressure`` — the fraction of the shared link
    one instance's current interval + KV traffic would consume — so
    admissions steer away from instances already saturating their share."""

    def __init__(self, link_bw: float):
        self.link_bw = link_bw

    def certify(self, instances: Sequence[InstanceState]
                ) -> CoordinationResult:
        return coordinate(instances, self.link_bw)

    def pressure(self, inst: InstanceState, interval: int) -> float:
        if self.link_bw <= 0:
            return 0.0
        return inst.link_rate(interval if interval else NO_OFFLOAD) \
            / self.link_bw


def max_interval_for_memory(num_units: int, unit_bytes: int,
                            hbm_budget_bytes: float) -> int:
    """Largest interval whose resident set fits the budget; NO_OFFLOAD if the
    whole model fits."""
    full = OffloadPlan(num_units, NO_OFFLOAD)
    if full.device_bytes(unit_bytes) <= hbm_budget_bytes:
        return NO_OFFLOAD
    for i in range(num_units, 0, -1):
        if OffloadPlan(num_units, i).device_bytes(unit_bytes) <= hbm_budget_bytes:
            return i
    return 0  # even interval 1 does not fit
