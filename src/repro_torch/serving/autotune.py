"""Online offloading-interval autotuner (paper §5, the online stage).

The offline stage (``core.record.PerformanceRecord`` + ``core.coordinator.
max_interval_for_memory``) brackets the interval: below ``min_interval`` the
SLO breaks even on an idle link, above ``max_interval`` the resident weights
don't fit HBM. Inside that range the best interval depends on runtime state
the record cannot see — pending KV link traffic, the tightest live TPOT
budget, queue depth — so the ``IntervalTuner`` re-picks it every iteration
from the same gauges the telemetry plane records.

Policy (the paper's objective is to maximize host memory, i.e. run at the
SMALLEST interval the latency budget tolerates):

  * candidates are the offline range ``[min_interval, max_interval]``
    (plus NO_OFFLOAD only when the whole model genuinely fits);
  * with an empty queue the tuner chases the objective directly: the
    smallest (= most host memory) candidate whose predicted latency fits
    the budget. Under a backlog the queue, not the iteration, is the
    user-visible latency, so it instead picks the SLO-feasible candidate
    with the highest estimated service rate (sustainable batch over
    predicted iteration time) — offloading harder than the backlog can
    afford would starve the drain and eventually the TTFT tail;
  * each candidate's next-iteration latency is predicted with the same
    analytic model the scheduler certifies against
    (``iter_time_with_interval_kv``), including the one-off demotion
    write-back a pool-shrinking resize would charge;
  * the tuner LIFTS host-ward (smaller interval) only after the same target
    stays feasible for ``lift_patience`` consecutive iterations — resizes
    demote/permute KV frames, so thrash is not free — and RETREATS
    (larger interval) immediately when the current interval's predicted
    latency leaves less than ``headroom_frac`` of the TPOT budget;
  * the executor may still refuse a resize (``ServingEngine.set_interval``
    returns False when the host pool cannot absorb the demoted KV). The
    engine bans the refused interval and asks again — ``note_refusal``
    keeps the count the trace footer exports.

Everything the tuner reads arrives through ``TunerGauges`` (plain values +
callables), so the policy is unit-testable without an engine, like the
scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Collection

from repro_torch.core.interval import (LayerTimes, NO_OFFLOAD,
                                 iter_time_with_interval_kv)


@dataclasses.dataclass
class TunerConfig:
    # fraction of the tightest TPOT budget the predicted iteration may fill;
    # the rest is slack for traffic the prediction cannot see (COW copies,
    # chunk spill, admission growth)
    headroom_frac: float = 0.8
    # consecutive iterations a host-ward lift target must stay stable before
    # the tuner pays the resize
    lift_patience: int = 2


@dataclasses.dataclass
class TunerGauges:
    """One iteration's runtime state, snapshotted by the engine (or stubbed
    by a policy test)."""
    batch: int                    # active decode slots
    queue_depth: int              # waiting + preempted requests
    min_interval: int             # offline floor (record, over live+head)
    max_interval: int             # memory ceiling (max_interval_for_memory)
    num_units: int
    times: LayerTimes
    kv_in_bytes: float            # pending PCIe in (streamed + swap-in)
    kv_out_bytes: float           # pending PCIe out (write-backs)
    tpot_budget_s: float          # tightest live TPOT SLO (inf if none)
    # one-off demotion write-back bytes a switch to interval i would charge
    # (0 for the current interval)
    resize_out_bytes: Callable[[int], float]
    # decode slots the KV capacity at interval i could sustain (device pool
    # + host spill headroom, clamped to the slot count) — the batch the
    # backlog could actually run at, not the batch running now
    batch_capacity: Callable[[int], int] | None = None
    disk_in_bytes: float = 0.0
    disk_out_bytes: float = 0.0
    disk_bw: float = 0.0
    disk_latency_s: float = 0.0
    # pending PEER-tier handoff traffic (live post-prefill KV import/export
    # in a disaggregated fleet) — its own concurrent link channel, like disk
    peer_in_bytes: float = 0.0
    peer_out_bytes: float = 0.0
    peer_bw: float = 0.0
    peer_latency_s: float = 0.0


class IntervalTuner:
    def __init__(self, cfg: TunerConfig | None = None):
        self.cfg = cfg or TunerConfig()
        self._streak: tuple[int, int] = (0, 0)   # (lift target, run length)
        self.lifts = 0
        self.retreats = 0
        self.refusals = 0

    # ------------------------------------------------------------- model --
    def candidates(self, g: TunerGauges) -> list[int]:
        """The offline range, memory bound respected (same shape as
        ``InstanceState.valid_intervals`` — no fallback when empty)."""
        top = min(g.max_interval, g.num_units)
        cands = list(range(max(1, g.min_interval), top + 1))
        if g.max_interval >= NO_OFFLOAD:
            cands.append(NO_OFFLOAD)
        return cands

    def predicted_dt_s(self, g: TunerGauges, interval: int,
                       current: int) -> float:
        """Next-iteration latency at ``interval``, including the demotion
        write-back a switch away from ``current`` would charge."""
        kv_out = g.kv_out_bytes
        if interval != current:
            kv_out += g.resize_out_bytes(interval)
        return iter_time_with_interval_kv(
            g.times, interval, g.kv_in_bytes, kv_out,
            disk_in_bytes=g.disk_in_bytes, disk_out_bytes=g.disk_out_bytes,
            disk_bw=g.disk_bw, disk_latency_s=g.disk_latency_s,
            peer_in_bytes=g.peer_in_bytes, peer_out_bytes=g.peer_out_bytes,
            peer_bw=g.peer_bw, peer_latency_s=g.peer_latency_s)

    # ------------------------------------------------------------ policy --
    def propose(self, g: TunerGauges, current: int,
                banned: Collection[int] = ()) -> int:
        """Interval for the next iteration. Returns ``current`` when holding
        position; the engine applies anything else through ``set_interval``
        and calls again with the target banned if the executor refuses."""
        cands = [c for c in self.candidates(g) if c not in banned]
        if not cands:
            return current
        budget = g.tpot_budget_s * self.cfg.headroom_frac
        feas = [c for c in cands
                if self.predicted_dt_s(g, c, current) <= budget]
        if not feas:
            # nothing feasible: shed as much transfer as memory allows
            target = cands[-1]
        elif g.queue_depth > 0:
            # backlog: the queue is the latency now, so pick the feasible
            # interval that drains it fastest — estimated tokens/s =
            # sustainable batch / predicted iteration time. A small interval
            # wins this only when its extra KV room grows the batch by more
            # than the extra weight transfers cost; otherwise the tuner
            # holds throughput and resumes chasing host memory once the
            # queue empties. Ties go host-ward.
            if g.batch_capacity is None:
                # the packing-plan gauge is mandatory in backlog mode:
                # falling back to a constant reduces the rate objective to
                # plain latency and silently re-introduces the
                # average-footprint over-admission the packing plan fixed
                raise ValueError("backlog-mode tuning requires the "
                                 "batch_capacity packing-plan gauge")

            def score(c: int) -> float:
                return (max(g.batch_capacity(c), 1)
                        / self.predicted_dt_s(g, c, current))
            best = max(score(c) for c in feas)
            target = next(c for c in feas if score(c) >= best * (1 - 1e-12))
        else:
            # keeping up: smallest feasible = most host memory (the
            # paper's objective)
            target = feas[0]
        if target == current:
            self._streak = (current, 0)
            return current
        current_ok = (current in cands
                      and self.predicted_dt_s(g, current, current) <= budget)
        if target < current and current_ok:
            # host-ward lift from a healthy position: demand stability
            last, n = self._streak
            n = n + 1 if last == target else 1
            self._streak = (target, n)
            if n < self.cfg.lift_patience:
                return current
            self.lifts += 1
            return target
        # retreat, or current position is itself infeasible/banned: move now
        self._streak = (target, 0)
        if target > current:
            self.retreats += 1
        else:
            self.lifts += 1
        return target

    def note_refusal(self, interval: int) -> None:
        """The executor could not apply ``interval`` (host pool cannot absorb
        the demoted KV). Counted for the trace footer; the engine bans the
        interval for the current iteration's re-plan."""
        self.refusals += 1
