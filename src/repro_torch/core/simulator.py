"""Two-stream discrete-event simulator (paper Fig. 7).

Simulates the compute stream and the copy stream of one inference iteration
under any offloading policy, with per-layer compute times (hybrids like jamba
have heterogeneous layers) and a shared host link. This is the validation
harness for the interval algebra and the engine behind the paper-figure
benchmarks (SLO maintenance, contention, throughput).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """Offload schedule of one instance for one iteration."""
    t_compute_s: Sequence[float]        # per layer
    transfer_s: Sequence[float]         # per layer; 0.0 = resident
    prefetch_start_layer: Sequence[int]  # layer index at which its transfer may start
    t_rest_s: float = 0.0
    # Two-tier KV traffic sharing the copy stream (serving.kv_offload):
    # kv_in gates layer-0 compute (swapped-in pages must land before
    # attention reads them); kv_out is issued right after (demoted pages
    # vacate device frames) and queues the weight prefetches behind it.
    kv_in_s: float = 0.0
    kv_out_s: float = 0.0


def schedule_for_interval(t_compute_s: Sequence[float], interval: int,
                          t_transfer_s: float, t_rest_s: float = 0.0,
                          lookahead_groups: int = 1,
                          kv_in_s: float = 0.0,
                          kv_out_s: float = 0.0) -> LayerSchedule:
    """Select-N schedule: every interval-th layer offloaded, prefetch issued
    at the first layer of the group (lookahead_groups=1) or earlier."""
    n = len(t_compute_s)
    transfer = [0.0] * n
    start = [0] * n
    if 1 <= interval <= n:
        groups = n // interval
        for g in range(groups):
            off = g * interval + interval - 1
            transfer[off] = t_transfer_s
            start[off] = max(0, (g - (lookahead_groups - 1)) * interval)
    return LayerSchedule(tuple(t_compute_s), tuple(transfer), tuple(start),
                         t_rest_s, kv_in_s=kv_in_s, kv_out_s=kv_out_s)


def schedule_deepspeed(t_compute_s: Sequence[float],
                       t_transfer_s: float, t_rest_s: float = 0.0
                       ) -> LayerSchedule:
    """DeepSpeed ZeRO-Inference: every layer offloaded, prefetch of layer j
    starts when layer j-1 starts (one-layer lookahead)."""
    n = len(t_compute_s)
    return LayerSchedule(
        tuple(t_compute_s), tuple([t_transfer_s] * n),
        tuple([max(0, j - 1) for j in range(n)]), t_rest_s)


def schedule_flexgen(t_compute_s: Sequence[float], fraction: float,
                     t_transfer_full_s: float, t_rest_s: float = 0.0
                     ) -> LayerSchedule:
    """FlexGen: a fixed fraction of every layer offloaded, one-layer
    lookahead prefetch."""
    n = len(t_compute_s)
    return LayerSchedule(
        tuple(t_compute_s), tuple([fraction * t_transfer_full_s] * n),
        tuple([max(0, j - 1) for j in range(n)]), t_rest_s)


def simulate_iteration(sched: LayerSchedule, bw_fraction: float = 1.0
                       ) -> dict:
    """Run one iteration; returns latency and stream utilization.

    bw_fraction scales every transfer (contention from bus neighbours).
    """
    n = len(sched.t_compute_s)
    scale = 1.0 / max(bw_fraction, 1e-9)
    # KV swap traffic leads the copy stream: swap-in gates layer-0 compute,
    # write-back overlaps compute but delays the first weight prefetch.
    t_kv_in = sched.kv_in_s * scale
    t_kv_out = sched.kv_out_s * scale
    # Transfers execute in layer order on a single copy stream.
    xfer_done = [0.0] * n
    copy_free = t_kv_in + t_kv_out
    compute_start = [0.0] * n
    t = t_kv_in
    stall = t_kv_in
    busy_copy = t_kv_in + t_kv_out

    # Precompute, for each layer j, the transfers whose prefetch window opens
    # at j (prefetch_start_layer == j).
    opens: list[list[int]] = [[] for _ in range(n)]
    for j in range(n):
        if sched.transfer_s[j] > 0:
            opens[sched.prefetch_start_layer[j]].append(j)

    pending: list[int] = []
    for j in range(n):
        compute_start[j] = t
        for k in opens[j]:
            pending.append(k)
        # issue pending transfers in order
        while pending:
            k = pending.pop(0)
            s = max(copy_free, t)
            d = s + sched.transfer_s[k] * scale
            xfer_done[k] = d
            copy_free = d
            busy_copy += sched.transfer_s[k] * scale
        if sched.transfer_s[j] > 0:
            wait = max(0.0, xfer_done[j] - t)
            stall += wait
            t += wait
        t += sched.t_compute_s[j]
    total = t + sched.t_rest_s
    return {
        "latency_s": total,
        "stall_s": stall,
        "compute_s": sum(sched.t_compute_s) + sched.t_rest_s,
        "copy_busy_s": busy_copy,
        "copy_util": busy_copy / total if total > 0 else 0.0,
    }


def simulate_shared_bus(scheds: Sequence[LayerSchedule],
                        link_bw_fraction_each: Sequence[float] | None = None,
                        total_bw: float = 1.0,
                        demands: Sequence[float] | None = None) -> list[dict]:
    """Instances sharing one host link.

    If the coordinator admitted them (sum of rates <= link), each instance
    sees its full requested bandwidth. If demands oversubscribe the link,
    every transfer is stretched by the oversubscription factor — the
    fair-share fluid model of PCIe arbitration.
    """
    if demands is not None:
        total = sum(demands)
        factor = min(1.0, total_bw / total) if total > 0 else 1.0
        fractions = [factor] * len(scheds)
    elif link_bw_fraction_each is not None:
        fractions = list(link_bw_fraction_each)
    else:
        fractions = [1.0] * len(scheds)
    return [simulate_iteration(s, f) for s, f in zip(scheds, fractions)]
