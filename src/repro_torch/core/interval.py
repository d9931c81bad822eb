"""Offloading interval — the paper's central abstraction (§4.3).

An interval of ``i`` means: of every i consecutive layers, the last one's
weights live in host memory and are prefetched starting at the *first* layer
of the interval, so (i-1) layers of compute hide the transfer. ``i = 1``
degenerates to DeepSpeed (everything offloaded); ``i > L`` means no
offloading.

The algebra below converts between (SLO, measured layer times) and intervals,
and computes the memory/bandwidth consequences a plan has — the quantities
the coordinator (§4.5) trades off.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

NO_OFFLOAD = 10**9  # sentinel interval: everything resident

# Relative tolerance for SLO feasibility comparisons (float accumulation).
_FEAS_RTOL = 1e-9


def _feasible(t: float, slo_s: float) -> bool:
    return t <= slo_s * (1.0 + _FEAS_RTOL) + 1e-12


@dataclasses.dataclass(frozen=True)
class LayerTimes:
    """Deterministic per-iteration timing of one model on one platform."""
    t_compute_s: float      # per layer (uniform; see per_layer for hybrids)
    t_transfer_s: float     # per layer host->device at full link bandwidth
    num_layers: int
    layer_bytes: int        # weight bytes of one layer (per instance shard)
    t_rest_s: float = 0.0   # non-stack time per iteration (embed/logits/...)

    @property
    def t_iter_no_offload_s(self) -> float:
        return self.num_layers * self.t_compute_s + self.t_rest_s


def max_offloadable_layers(times: LayerTimes, slo_s: float) -> int:
    """Paper §4.4: L_offload = floor(t_compute_total * (1+delta) / t_transfer)
    where delta is the SLO headroom over the no-offload iteration time.

    Interpretation: every offloaded layer costs one transfer; transfers
    overlap compute, so the total transfer time must fit inside the compute
    time plus the SLO slack.
    """
    t0 = times.t_iter_no_offload_s
    if slo_s < t0 or times.t_transfer_s <= 0:
        return 0
    delta = (slo_s - t0) / t0
    total_compute = times.num_layers * times.t_compute_s
    budget = total_compute * (1.0 + delta) + times.t_rest_s * delta
    return min(times.num_layers, int(budget / times.t_transfer_s))


def paper_interval_formula(times: LayerTimes, slo_s: float) -> int:
    """The paper's closed form: floor(L / L_offload). NOTE: this is a lower
    bound, not always feasible — it assumes each transfer can overlap *all*
    compute, but an interval-i transfer only overlaps its own group's (i-1)
    layers. Our property tests exhibit violations (e.g. t_c == t_t, zero
    slack => interval 1, 2x the SLO). See DESIGN.md §9.
    """
    l_off = max_offloadable_layers(times, slo_s)
    if l_off <= 0:
        return NO_OFFLOAD
    return max(1, math.floor(times.num_layers / l_off))


def optimal_interval(times: LayerTimes, slo_s: float) -> int:
    """Smallest SLO-feasible interval: the paper's closed form as the initial
    guess, verified against the exact schedule latency and bumped until
    feasible (still O(L) worst case, done offline by the analyzer)."""
    guess = paper_interval_formula(times, slo_s)
    if guess >= NO_OFFLOAD:
        return NO_OFFLOAD
    for i in range(guess, times.num_layers + 1):
        if _feasible(iter_time_with_interval(times, i), slo_s):
            return i
    return NO_OFFLOAD


def link_bandwidth(times: LayerTimes) -> float:
    """Host-link bandwidth (bytes/s) implied by the measured layer transfer
    time. Zero if the times carry no transfer measurement."""
    if times.t_transfer_s <= 0:
        return 0.0
    return times.layer_bytes / times.t_transfer_s


def kv_transfer_seconds(times: LayerTimes, kv_bytes: float,
                        link_bw: float | None = None) -> float:
    """Copy-stream seconds to move ``kv_bytes`` of KV pages over the same
    host link the weight prefetches use."""
    if kv_bytes <= 0:
        return 0.0
    bw = link_bw if link_bw is not None else link_bandwidth(times)
    if bw <= 0:
        raise ValueError("KV traffic needs a link bandwidth: times has "
                         "t_transfer_s == 0 and no link_bw was given")
    return kv_bytes / bw


def iter_time_with_interval(times: LayerTimes, interval: int) -> float:
    """Analytic iteration latency under interval ``i`` with Select-N's
    group-start prefetch and a single copy stream (paper Fig. 7).

    Matches ``simulator.simulate_iteration`` for uniform layer times
    (property-tested).
    """
    return iter_time_with_interval_kv(times, interval)


def disk_transfer_seconds(disk_in_bytes: float, disk_out_bytes: float,
                          disk_bw: float, disk_latency_s: float = 0.0
                          ) -> float:
    """NVMe-channel seconds for one iteration's disk-tier KV traffic
    (three-tier offloading, see serving.kv_offload). The disk link is its
    own channel — its bytes must never ride the PCIe copy stream the
    weight prefetches and host-tier KV share — but it is also never free:
    an iteration that staged or demoted disk pages cannot complete before
    its NVMe queue drains."""
    total = disk_in_bytes + disk_out_bytes
    if total <= 0:
        return 0.0
    if disk_bw <= 0:
        raise ValueError("disk KV traffic needs a disk link bandwidth")
    return disk_latency_s + total / disk_bw


def peer_transfer_seconds(peer_in_bytes: float, peer_out_bytes: float,
                          peer_bw: float, peer_latency_s: float = 0.0
                          ) -> float:
    """Peer-link seconds for one iteration's cross-instance KV handoff
    traffic (disaggregated prefill/decode, see serving.fleet). The peer
    link — NIC/NVLink to another instance's host pool — is its own channel
    like the NVMe link: its bytes never ride the local PCIe copy stream,
    but an iteration that imported or exported handoff pages cannot
    complete before its peer queue drains."""
    total = peer_in_bytes + peer_out_bytes
    if total <= 0:
        return 0.0
    if peer_bw <= 0:
        raise ValueError("peer KV traffic needs a peer link bandwidth")
    return peer_latency_s + total / peer_bw


@dataclasses.dataclass(frozen=True)
class IterTimeBreakdown:
    """One iteration's modeled latency, decomposed by what the clock was
    charged for (the telemetry plane records these per iteration instead of
    the folded ``total_s`` float).

    Identities (the trace auditor machine-checks them):
      ``total_s == max(pcie_s, disk_s, peer_s)`` exactly, and
      ``pcie_s == kv_in_s + compute_s + stall_s`` up to float reassociation.
    """
    total_s: float        # what iter_time_with_interval_kv returns
    pcie_s: float         # PCIe copy-stream schedule incl. all compute
    disk_s: float         # NVMe channel drain (own term, never rides PCIe)
    compute_s: float      # num_layers * t_compute + t_rest (no-offload time)
    kv_in_s: float        # h2d KV copy gating layer-0 compute
    kv_out_s: float       # d2h write-back occupancy of the copy stream
    stall_s: float        # compute stalled on queued weight prefetches
    peer_s: float = 0.0   # peer-link drain (cross-instance KV handoff)


def iter_time_breakdown_kv(times: LayerTimes, interval: int,
                           kv_in_bytes: float = 0.0,
                           kv_out_bytes: float = 0.0,
                           link_bw: float | None = None,
                           disk_in_bytes: float = 0.0,
                           disk_out_bytes: float = 0.0,
                           disk_bw: float = 0.0,
                           disk_latency_s: float = 0.0,
                           peer_in_bytes: float = 0.0,
                           peer_out_bytes: float = 0.0,
                           peer_bw: float = 0.0,
                           peer_latency_s: float = 0.0) -> IterTimeBreakdown:
    """``iter_time_with_interval_kv`` with the latency decomposed into its
    compute / link-queue / disk-queue / peer-queue terms. ``total_s`` is
    bit-identical to the folded form — the wrapper below delegates here, so
    the two can never drift."""
    t_disk = disk_transfer_seconds(disk_in_bytes, disk_out_bytes,
                                   disk_bw, disk_latency_s)
    t_peer = peer_transfer_seconds(peer_in_bytes, peer_out_bytes,
                                   peer_bw, peer_latency_s)
    t_kv_in = kv_transfer_seconds(times, kv_in_bytes, link_bw)
    t_kv_out = kv_transfer_seconds(times, kv_out_bytes, link_bw)
    compute = times.t_iter_no_offload_s
    if interval >= times.num_layers + 1 or interval >= NO_OFFLOAD:
        # no weight prefetches: the d2h write-back overlaps compute without
        # queueing anything behind it (kv_out_s is occupancy, not delay)
        pcie = t_kv_in + times.t_iter_no_offload_s
        return IterTimeBreakdown(total_s=max(pcie, t_disk, t_peer),
                                 pcie_s=pcie,
                                 disk_s=t_disk, compute_s=compute,
                                 kv_in_s=t_kv_in, kv_out_s=t_kv_out,
                                 stall_s=pcie - t_kv_in - compute,
                                 peer_s=t_peer)
    i, tc, tt = interval, times.t_compute_s, times.t_transfer_s
    groups = times.num_layers // i
    t = t_kv_in
    copy_free = t_kv_in + t_kv_out
    for g in range(groups):
        group_start = t
        xfer_start = max(group_start, copy_free)
        xfer_done = xfer_start + tt
        copy_free = xfer_done
        t = group_start + (i - 1) * tc          # resident layers
        t = max(t, xfer_done) + tc              # offloaded layer
    t += (times.num_layers - groups * i) * tc   # remainder layers (resident)
    pcie = t + times.t_rest_s
    return IterTimeBreakdown(total_s=max(pcie, t_disk, t_peer), pcie_s=pcie,
                             disk_s=t_disk, compute_s=compute,
                             kv_in_s=t_kv_in, kv_out_s=t_kv_out,
                             stall_s=pcie - t_kv_in - compute,
                             peer_s=t_peer)


def iter_time_with_interval_kv(times: LayerTimes, interval: int,
                               kv_in_bytes: float = 0.0,
                               kv_out_bytes: float = 0.0,
                               link_bw: float | None = None,
                               disk_in_bytes: float = 0.0,
                               disk_out_bytes: float = 0.0,
                               disk_bw: float = 0.0,
                               disk_latency_s: float = 0.0,
                               peer_in_bytes: float = 0.0,
                               peer_out_bytes: float = 0.0,
                               peer_bw: float = 0.0,
                               peer_latency_s: float = 0.0) -> float:
    """Iteration latency when KV-page traffic shares the copy stream with
    weight prefetch (tiered KV offloading, see serving.kv_offload).

    Model — one PCIe copy stream, strict issue order (matches the event
    simulator's extended ``LayerSchedule``, property-tested):

      1. ``kv_in_bytes`` (host->device swap-in / streamed host-resident KV)
         is issued first and gates layer-0 compute — attention cannot read
         pages that are not on device yet.
      2. ``kv_out_bytes`` (device->host write-back of demoted pages) is
         issued next: demotions must vacate device frames before this
         iteration reuses them.  The write overlaps compute but queues the
         weight prefetches behind it.
      3. Weight prefetches then follow the Fig. 7 group-start schedule.

    Every byte is charged exactly once: KV bytes occupy the copy stream
    before the first weight transfer, so combined traffic is neither
    double-counted nor hidden.

    Disk-tier traffic (``disk_in_bytes`` / ``disk_out_bytes``) runs on its
    OWN channel (NVMe) concurrently with the PCIe schedule, and so does
    cross-instance handoff traffic (``peer_in_bytes`` / ``peer_out_bytes``)
    on the peer link: the iteration ends when every channel drains,
    ``max(t_pcie, t_disk, t_peer)`` — disk and peer bytes get their own
    terms instead of silently riding (or being hidden from) the PCIe
    budget the TPOT math certifies. With no disk or peer traffic this
    reduces exactly to the two-tier model.

    ``iter_time_breakdown_kv`` exposes the same latency decomposed into
    compute / link-queue / disk-queue / peer-queue terms (what the
    telemetry plane records); this wrapper returns its ``total_s``."""
    return iter_time_breakdown_kv(
        times, interval, kv_in_bytes, kv_out_bytes, link_bw,
        disk_in_bytes, disk_out_bytes, disk_bw, disk_latency_s,
        peer_in_bytes, peer_out_bytes, peer_bw, peer_latency_s).total_s


def min_feasible_interval(times: LayerTimes, slo_s: float) -> int:
    """Exact search: smallest interval whose simulated latency meets slo."""
    for i in range(1, times.num_layers + 1):
        if _feasible(iter_time_with_interval(times, i), slo_s):
            return i
    return NO_OFFLOAD


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    """Concrete placement for a stack of ``num_units`` scan units."""
    num_units: int
    interval: int

    @property
    def enabled(self) -> bool:
        return 1 <= self.interval <= self.num_units

    @property
    def num_groups(self) -> int:
        return self.num_units // self.interval if self.enabled else 0

    @property
    def num_offloaded(self) -> int:
        return self.num_groups

    @property
    def num_resident(self) -> int:
        return self.num_units - self.num_offloaded

    @property
    def tail_units(self) -> int:
        """Units after the last full group; always resident."""
        return self.num_units - self.num_groups * self.interval if self.enabled \
            else self.num_units

    def offloaded_indices(self) -> list[int]:
        if not self.enabled:
            return []
        return [g * self.interval + self.interval - 1
                for g in range(self.num_groups)]

    # ---- resource accounting ------------------------------------------------
    def host_bytes(self, layer_bytes: int) -> int:
        return self.num_offloaded * layer_bytes

    def device_bytes(self, layer_bytes: int) -> int:
        # resident layers + two transfer buffers (current + prefetched)
        bufs = 2 if self.enabled else 0
        return (self.num_resident + bufs) * layer_bytes

    def link_bytes_per_iter(self, layer_bytes: int) -> int:
        return self.num_offloaded * layer_bytes

    def link_rate(self, layer_bytes: int, t_iter_s: float) -> float:
        """Host-link bandwidth this plan consumes (paper Fig. 8 lines 4-13)."""
        if t_iter_s <= 0:
            return 0.0
        return self.link_bytes_per_iter(layer_bytes) / t_iter_s


def plan_for(num_units: int, interval: int) -> OffloadPlan:
    return OffloadPlan(num_units=num_units, interval=interval)
