"""SLO-aware serving executor: paged-kernel decode with Select-N offloading
(port of ``repro.serving.engine``).

One engine = one model instance on one device. Scheduling POLICY lives in
``serving.scheduler``: per iteration the engine snapshots its state into a
``SchedulerView``, receives an ``IterationPlan`` (preemptions, resumes,
admissions, prefill chunks, decode slots), applies it — page copies,
prefill compute + scatter, one decode step for all active slots — and
reports an ``IterationOutcome`` back. The engine still owns the *modeled*
clock (LayerTimes under the current offload plan — token flow is real
PyTorch compute; SLO timing is the deterministic analytic schedule) and
every physical page byte. On a GPU it also records the stream time of each
prefill, incremental prefill chunk and decode step (``prefill_ms`` /
``chunk_ms`` / ``decode_ms``, CUDA events around the step, host gaps
included).

Decode computes through the paged decode kernel against a SINGLE physical
page-pool buffer: the frames the ``TieredKVAllocator`` accounts for are the
frames the kernel reads, so the accounting pool and the compute pool are one
object. Layout of ``self.pool`` ([frames, page, L, 2, vh, hd], bf16 like the
dense cache spec):

  frames [0, dev_cap)          device-tier frames. Accounting frame ids are
                               always < dev_cap because the free list is
                               LIFO: a fresh id is handed out only when every
                               lower id is in use, so the high-water mark is
                               bounded by peak concurrency
                               (max_batch * pages_for(max_seq), plus one
                               still-unconsumed COW reserve per slot when
                               prefix dedup is on).
  frames [dev_cap, 2*dev_cap)  the streaming slab: host-resident pages of
                               active requests are gathered here each
                               iteration for attention (no residency change —
                               this is the per-iteration streamed traffic the
                               swap scheduler charges to the link).
  frame  2*dev_cap             the null frame: idle batch rows and padded
                               block-table slots point here.

Prefill scatters new KV into allocated frames (``kernels.ops`` batched
scatter); swap-in/out and interval-driven resizes copy directly between the
host pool (a CPU tensor, pinned on a GPU) and this same buffer (no repack).
The offloading interval is re-evaluated every iteration through the per-bus
coordinator when the engine shares a link with peers (§4.5).

With ``incremental_prefill``, each prefill chunk runs through the paged
chunk-prefill kernel against the request's resident pages (host-tier pages
stream through the slab and the pages the chunk writes stream back), so
every prompt token is computed once.

Not ported yet (the constructor refuses them): the disk KV tier and the
async copy-stage data plane (ROADMAP Queue A item 6), and the fleet roles
with cross-instance migration and handoff (Queue A item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core.coordinator import (InstanceState, coordinate,
                                          max_interval_for_memory)
from repro_torch.core.hardware import HardwareModel
from repro_torch.core.interval import (LayerTimes, NO_OFFLOAD, OffloadPlan,
                                       iter_time_breakdown_kv,
                                       iter_time_with_interval_kv,
                                       link_bandwidth)
from repro_torch.core.memory_manager import (OffloadRuntime, merge_stacked,
                                             split_model_params)
from repro_torch.core.record import PerformanceRecord
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.models.spec import tree_map
from repro_torch.models.transformer import pattern_info
from repro_torch.serving.autotune import IntervalTuner, TunerGauges
from repro_torch.serving.kv_cache import PageConfig, PagedKVAllocator
from repro_torch.serving.kv_offload import (DEVICE, HOST, LinkSpec,
                                            SwapScheduler, TieredKVAllocator)
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import (ActiveInfo, IterationOutcome,
                                           IterationPlan, PlannedPreemption,
                                           PlannedResume, PrefillChunk,
                                           Scheduler, SchedulerConfig,
                                           SchedulerView)
from repro_torch.serving.telemetry import (IterationRecord, SlotGauge,
                                           TraceRecorder, summarize_latency)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 64
    hbm_budget_bytes: float = 16e9
    page_size: int = 16
    greedy: bool = True          # greedy sampling
    # Two-tier KV offloading (serving.kv_offload): pinned-host page pool
    # budget. 0 disables the host tier — admission then falls back to the
    # device-only behavior (wait for pages).
    host_kv_bytes: float = 0.0
    # Cross-request prefix dedup + copy-on-write pages: prompts sharing a
    # prefix with a live/host-parked request map onto the same physical
    # frames (refcount += 1); a write into a shared page moves the writer
    # onto its pre-claimed private frame first. Off by default — the
    # dedup-off engine is the PR-2 baseline the differential suite locksteps
    # against.
    prefix_dedup: bool = False
    # Scheduling policies (serving.scheduler). Both default off — the
    # policy-off scheduler reproduces the fused engine's admission decisions
    # exactly, which is what the differential suite locksteps.
    preemption: bool = False           # preempt-to-host under admission stalls
    prefill_chunk_tokens: int = 0      # >0: chunked prefill, page-aligned
    # Prefix-cache keep-alive: host frames whose last owner freed survive
    # (LRU, this many pages) so a re-submitted shared prefix still dedups.
    host_prefix_cache_pages: int = 0
    # Disk (NVMe) KV tier below the host pool: parked/preempted requests
    # and aged-out prefix-cache frames retire here under host pressure
    # instead of blocking parks / evicting cache. 0 disables the tier —
    # the three-tier engine with disk disabled is bit-identical to the
    # two-tier baseline (differential-gated).
    disk_kv_bytes: float = 0.0
    # NVMe link model: traffic to/from the disk tier gets its own term in
    # the iteration-latency model (it never rides the PCIe budget).
    disk_bw_bytes_s: float = 3e9
    disk_latency_s: float = 1e-4
    # Optional file path for the disk pool's backing store (np.memmap);
    # None keeps a RAM buffer standing in for NVMe.
    disk_backing_path: str | None = None
    # Async data plane (serving.data_plane): queue the allocator's copy
    # hooks in planning order and drain them at the next iteration
    # boundary — batched gather/scatter runs, host->disk retirements on a
    # background worker overlapping decode, and a staged prefetch of the
    # oldest parked request's disk pages ahead of its predicted resume.
    # Off = every hook copy executes synchronously at plan time (the PR 5
    # behavior, bitwise identical token streams either way).
    async_data_plane: bool = False
    # Staged-prefetch depth: disk pages of the oldest parked request staged
    # host-ward per iteration boundary (async mode only). 1 keeps the
    # conservative one-page cadence; deeper drains a parked request's disk
    # set in fewer boundaries at the cost of host frames held earlier. The
    # effective depth is always bounded by free host frames.
    prefetch_pages_per_boundary: int = 1
    # Incremental chunked prefill: each chunk attends only its own queries
    # against the resident paged KV (paged chunk-prefill kernel) instead of
    # recomputing the whole prefix per chunk. Opt-in: chunk logits now see
    # the pool's bf16-rounded prefix KV, so numerics differ from the
    # whole-prefix recompute path at rounding level.
    incremental_prefill: bool = False
    # Online interval autotuning (serving.autotune): re-pick the offloading
    # interval every iteration inside the offline record's feasible range
    # from runtime gauges (pending link traffic, tightest live TPOT budget,
    # queue depth) — the paper's §5 online stage. Mutually exclusive with
    # the peer coordinator, which owns the interval when a link is shared.
    autotune: bool = False
    # Instance role in a disaggregated fleet (serving.fleet): "mixed" runs
    # the full request lifecycle (the symmetric fleet behavior); "prefill"
    # computes prompts and hands each finished prefill peer-ward; "decode"
    # adopts handed-off requests and decodes them. Role typing only changes
    # fleet routing/handoff policy — the engine itself can always do both.
    role: str = "mixed"
    # Peer link model (PEER tier): KV handoff traffic to/from other
    # instances gets its own term in the iteration-latency model, exactly
    # like the NVMe link — it never rides the PCIe budget.
    peer_bw_bytes_s: float = 16e9
    peer_latency_s: float = 1e-5


class ServingEngine:
    def __init__(self, name: str, model: Model, hw: HardwareModel,
                 rec_prefill: PerformanceRecord, rec_decode: PerformanceRecord,
                 times_fn: Callable[[int, int, str], LayerTimes],
                 ecfg: EngineConfig = EngineConfig(), *,
                 device: torch.device | str = "cuda",
                 params: dict | None = None):
        """``device``: where the model computes ("cuda" unless the caller
        asks for the CPU). ``params``: an initialized parameter tree (the
        tests inject weights bridged from the reference); by default the
        weights are drawn from ``torch.Generator`` seed 0."""
        for flag, item in (("disk_kv_bytes", "Queue A item 6 (disk tier)"),
                           ("async_data_plane",
                            "Queue A item 6 (copy-stage data plane)")):
            if getattr(ecfg, flag):
                raise NotImplementedError(
                    f"EngineConfig.{flag} is not ported yet: ROADMAP {item}")
        if ecfg.role != "mixed":
            raise NotImplementedError(
                f"instance role {ecfg.role!r} belongs to the fleet, which is "
                "not ported yet: ROADMAP Queue A item 7")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # full-precision fp32 products (no TF32) on the card
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.name = name
        self.model = model
        self.cfg: ModelConfig = model.cfg
        if (any(b.mixer != "attention" for b in self.cfg.pattern)
                or self.cfg.encoder_layers > 0
                or self.cfg.frontend is not None
                or self.cfg.sliding_window > 0):
            raise NotImplementedError(
                "the paged engine path requires an attention-only decoder "
                "(no encoder / frontend / sliding window): recurrent-state "
                "slabs and windowed prefill unpacking are ROADMAP items")
        self.hw = hw
        self.rec = {"prefill": rec_prefill, "decode": rec_decode}
        self.times_fn = times_fn
        self.ecfg = ecfg
        _, self.num_units = pattern_info(self.cfg)
        self.unit_bytes = costs.unit_weight_bytes(self.cfg)

        if params is None:
            gen = torch.Generator(self.device).manual_seed(0)
            params = model.init(gen, self.device)
        # the master copy lives on the host: each interval's split places
        # its resident units on the device and its offloaded units in pinned
        # host memory (see _rt), so offloaded weights never occupy the card
        self.params = tree_map(lambda t: t.cpu(), params)
        del params
        self.clock_s = 0.0
        self.interval = NO_OFFLOAD
        self.finished: list[Request] = []
        self.rejected: list[Request] = []

        # slot state
        b = ecfg.max_batch
        self.slot_req: list[Request | None] = [None] * b
        self.tokens = np.zeros((b,), np.int32)
        self.pos = np.zeros((b,), np.int32)
        self.active = np.zeros((b,), bool)

        kv_tok = max(costs.kv_cache_bytes(self.cfg, 1, 1,
                                          self.model.virtual_kv), 1)
        weight_free = (ecfg.hbm_budget_bytes
                       - OffloadPlan(self.num_units, NO_OFFLOAD)
                       .device_bytes(self.unit_bytes))
        # prefix-dedup scope: frames are content-addressed per model config
        # AND page geometry — two engines with different weights or page
        # sizes must never map onto each other's hashes
        scope = f"{self.cfg!r}|page={ecfg.page_size}"
        self.kv = TieredKVAllocator(
            max(int(weight_free), 0), ecfg.host_kv_bytes,
            PageConfig(ecfg.page_size, bytes_per_token=kv_tok),
            scope=scope, enable_dedup=ecfg.prefix_dedup,
            host_prefix_cache_pages=ecfg.host_prefix_cache_pages,
            disk_bytes=ecfg.disk_kv_bytes,
            disk_link=LinkSpec(bw_bytes_s=ecfg.disk_bw_bytes_s,
                               latency_s=ecfg.disk_latency_s),
            disk_backing_path=ecfg.disk_backing_path,
            peer_link=LinkSpec(bw_bytes_s=ecfg.peer_bw_bytes_s,
                               latency_s=ecfg.peer_latency_s))
        if ecfg.role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown instance role {ecfg.role!r}")
        self.role = ecfg.role
        self.swap = SwapScheduler(self.kv)
        # policy layer: owns the queue, the preempted set and slot
        # assignment; this engine executes the plans it emits
        self.scheduler = Scheduler(
            self.kv, self.swap, ecfg.max_batch, ecfg.max_seq,
            rec_decode, self.times_fn, self._modeled_ttft,
            self._max_interval_now,
            SchedulerConfig(preemption=ecfg.preemption,
                            prefill_chunk_tokens=ecfg.prefill_chunk_tokens),
            prefill_seconds=self._prefill_seconds)
        self.host_kv_peak_pages = 0
        self.streamed_pages_peak = 0
        self.device_pages_peak = 0
        self.disk_kv_peak_pages = 0
        self.cow_events = 0

        # physical page pool (see module docstring for the frame map).
        # With dedup, a slot can pin pages_for(max_seq) block-table frames
        # PLUS one still-unconsumed COW reserve, so the LIFO high-water
        # bound gains one frame per slot.
        self.nb = self.kv.device.pages_for(ecfg.max_seq)
        self.dev_cap = ecfg.max_batch * (self.nb + int(ecfg.prefix_dedup))
        self.slab_base = self.dev_cap
        self.null_frame = 2 * self.dev_cap
        vh, hd = self.model.virtual_kv, self.cfg.resolved_head_dim
        self.page_shape = (ecfg.page_size, self.cfg.num_layers, 2, vh, hd)
        self.pool = torch.zeros((self.null_frame + 1, *self.page_shape),
                                dtype=torch.bfloat16, device=self.device)
        self.host_pool = (torch.zeros(
            (self.kv.host.total_pages, *self.page_shape), dtype=torch.bfloat16,
            pin_memory=self.device.type == "cuda")
            if self.kv.host.total_pages > 0 else None)
        self.prefetch_pages_total = 0

        if ecfg.incremental_prefill and ecfg.prefix_dedup:
            raise NotImplementedError(
                "incremental prefill under prefix dedup needs skip-write/"
                "COW handling for deduped chunk pages (ROADMAP)")
        self.prefill_tokens_computed = 0   # quadratic-vs-linear evidence
        self.chunk_pages_streamed = 0      # host pages incremental chunks read

        # the current interval's runtime and placed parameters (see _rt)
        self._runtime: OffloadRuntime | None = None
        self._placed: Any = None
        self._prefetch_copies_done = 0    # by runtimes already released
        # stream time of each prefill / incremental chunk / decode step (GPU
        # only): CUDA events around the step, so the gaps while the host
        # issues work count too
        self.prefill_ms: list[float] = []
        self.chunk_ms: list[float] = []
        self.decode_ms: list[float] = []

        # per-step observability for the differential harness
        self.prefill_log: list[tuple[Request, int, np.ndarray]] = []
        self.last_decode: dict | None = None

        # iteration-level telemetry plane (serving.telemetry): always on —
        # records are tiny and the differential suites audit every run
        self.trace = TraceRecorder(name, ecfg.max_batch, self.kv.page_bytes)
        self.trace._footer_fn = self._trace_footer
        self.cow_in_bytes_total = 0.0
        self.cow_out_bytes_total = 0.0

        # online interval autotuner (§5 online stage) + interval telemetry
        self.tuner: IntervalTuner | None = \
            IntervalTuner() if ecfg.autotune else None
        self.interval_refusals = 0     # set_interval refused a resize
        self.interval_switches = 0     # applied interval changes
        # modeled time run() spent idle waiting for the next arrival; the
        # pending amount is stamped on the next iteration record so the
        # trace auditor can still tile the clock
        self.idle_wait_s = 0.0
        self.idle_wait_total_s = 0.0
        # cross-instance migration (fleet): ticket bytes sent/received over
        # the peer link and the modeled transfer seconds charged to THIS
        # instance's clock. Pending amounts accumulate between iterations
        # and are stamped on the next record (same idle_wait_s discipline),
        # so the trace auditor can tile the clock and conserve the bytes
        self.mig_in_bytes_total = 0.0
        self.mig_out_bytes_total = 0.0
        self.pending_mig_in_bytes = 0.0
        self.pending_mig_out_bytes = 0.0
        self.mig_wait_s = 0.0
        self.mig_wait_total_s = 0.0
        self.n_migrated_in = 0
        self.n_migrated_out = 0
        # live post-prefill KV handoff (disaggregated fleet): ticket bytes
        # exported/imported over the PEER tier's link. Unlike emergency
        # migration, a handoff transfer is never charged synchronously to
        # either clock — each side's pages drain into its own next
        # iteration's peer-link term (note_peer_export/import ->
        # SwapPlan.peer_* -> peer_s), so the transfer overlaps modeled
        # compute like any other offload channel.
        self.handoff_in_bytes_total = 0.0
        self.handoff_out_bytes_total = 0.0
        self.n_handoff_in = 0
        self.n_handoff_out = 0

    # ------------------------------------------------------------------ plan --
    @property
    def allocator(self) -> PagedKVAllocator:
        """Device-tier page pool (back-compat accessor)."""
        return self.kv.device

    def _plan(self, interval: int) -> OffloadPlan:
        return OffloadPlan(self.num_units, interval)

    def set_interval(self, interval: int) -> bool:
        """Apply a (possibly new) offloading interval before the next
        iteration (coordinator/tuner output). Re-splits params lazily; the
        KV pool is re-accounted and the physical frames follow the remap.

        Returns True when the interval is in effect afterwards (applied, or
        already current), False when the executor REFUSED the resize:
        growing the resident set would orphan live KV pages the host pool
        cannot absorb. Callers owning interval policy (coordinator re-plan,
        tuner) must treat False as "re-plan without this interval" — the
        engine still runs at the old interval and ``instance_state`` keeps
        reporting it."""
        if interval == self.interval:
            return True
        weight_free_new = (self.ecfg.hbm_budget_bytes
                           - self._plan(interval).device_bytes(self.unit_bytes))
        if not self.kv.can_resize_device(max(int(weight_free_new), 0)):
            # memory-bound refusal: ``max_interval_for_memory`` bounds the
            # resident weights against HBM minus *used* KV, but absorbing
            # the displaced KV needs host free pages too — under host
            # pressure that can fail, and the caller must re-plan
            self.interval_refusals += 1
            if self.tuner is not None:
                self.tuner.note_refusal(interval)
            return False
        self.interval = interval
        self.interval_switches += 1
        self._release_placement()
        # re-account KV budget: resident bytes changed. A shrinking device
        # pool demotes KV pages host-ward; the write-back bytes are charged
        # to the next iteration's link budget by the swap scheduler. The
        # physical pool mirrors the accounting moves: demoted frames are
        # copied out while still intact, then surviving frames permute.
        res = self.kv.resize_device(max(int(weight_free_new), 0))
        if res.demotions:
            assert self.host_pool is not None
            ops.copy_pages_to_host(self.pool,
                                   [m.src_page for m in res.demotions],
                                   self.host_pool,
                                   [m.dst_page for m in res.demotions])
            self.swap.note_demotions(len(res.demotions))
        moves = [(o, n) for o, n in res.remap if o != n]
        if moves:
            # gathered before the scatter: a permutation may read frames it
            # also writes
            got = ops.gather_kv_pages(self.pool, [o for o, _ in moves])
            self.pool = ops.scatter_kv_pages(self.pool,
                                             [n for _, n in moves], got)
        return True

    def _rt(self) -> tuple[OffloadRuntime, Any]:
        """The current interval's runtime and its placed parameter tree,
        placed on first use. One placement is held at a time: an interval
        switch releases the previous one, so the device holds the resident
        units the HBM budget accounts for and no stale ones."""
        if self._runtime is None or self._runtime.plan.interval != \
                self.interval:
            self._release_placement()
            rt = OffloadRuntime(model=self.model,
                                plan=self._plan(self.interval),
                                device=self.device)
            self._placed = rt.place(split_model_params(self.params, rt.plan))
            self._runtime = rt
        return self._runtime, self._placed

    def _release_placement(self) -> None:
        """Drop the placed parameters: their device tensors and pinned
        buffers return to PyTorch's allocators once queued work that reads
        them has run."""
        if self._runtime is not None:
            self._prefetch_copies_done += self._runtime.prefetch_copies
        self._runtime = self._placed = None

    @property
    def prefetch_copies(self) -> int:
        """Offloaded weight units copied host-to-device (side stream), over
        every interval this engine has run at."""
        live = self._runtime.prefetch_copies if self._runtime else 0
        return self._prefetch_copies_done + live

    @property
    def host_weight_bytes(self) -> int:
        """Weight bytes the current interval's placement holds in pinned
        host memory (0 before the first step and on the CPU)."""
        return self._runtime.host_weight_bytes if self._runtime else 0

    # ------------------------------------------------------------ admission --
    @property
    def queue(self) -> list[Request]:
        """Waiting requests (owned by the scheduler; back-compat accessor)."""
        return self.scheduler.queue

    def _active_rids(self) -> list[int]:
        return [r.rid for r in self.slot_req if r is not None]

    def _max_interval_now(self) -> int:
        """Memory-bounded interval ceiling under current KV usage (shared by
        the coordinator state and the scheduler's admission check)."""
        return max_interval_for_memory(
            self.num_units, self.unit_bytes,
            self.ecfg.hbm_budget_bytes
            - self.allocator.used_pages * self.allocator.page_bytes)

    def _min_interval_now(self) -> int:
        """SLO floor on the interval under the CURRENT population: the max
        of the record lookups for the head-of-queue waiting request (at the
        batch its admission would create) and every active slot's TPOT SLO.
        A coordinator/tuner rebalance below this would break a live request,
        not just the next admission."""
        batch = self._active_batch()
        waiting = self.queue[0] if self.queue else None
        floors = []
        if waiting is not None:
            seq = waiting.prompt_len + waiting.max_new_tokens
            floors.append(self.rec["decode"].lookup(waiting.tpot_slo_s,
                                                    batch + 1, seq))
        for req in self.slot_req:
            if req is None:
                continue
            seq = req.prompt_len + req.max_new_tokens
            floors.append(self.rec["decode"].lookup(req.tpot_slo_s,
                                                    max(batch, 1), seq))
        if not floors:
            # empty engine: hold the current position (idle instances don't
            # constrain the coordinator anyway)
            return self.interval if self.interval < NO_OFFLOAD else 1
        return max(floors)

    def instance_state(self, idle: bool | None = None) -> InstanceState:
        min_i = self._min_interval_now()
        times = self.times_fn(max(self._active_batch(), 1),
                              self.ecfg.max_seq, "decode")
        max_i = self._max_interval_now()
        kv_stream = (self.swap.streamed_bytes(self._active_rids())
                     + self.swap.pending_in_bytes())
        kv_out = self.swap.pending_out_bytes()
        return InstanceState(
            name=self.name, num_units=self.num_units,
            unit_bytes=self.unit_bytes,
            # NVMe is instance-local: its pending traffic lengthens this
            # instance's iteration (own term) but is not part of the
            # shared-PCIe rate the coordinator arbitrates
            # (kv_bytes_per_iter stays PCIe-only)
            t_iter_s=iter_time_with_interval_kv(
                times, self.interval if self.interval else NO_OFFLOAD,
                kv_stream, kv_out,
                disk_in_bytes=self.swap.pending_disk_in_bytes(),
                disk_out_bytes=self.swap.pending_disk_out_bytes(),
                disk_bw=self.kv.disk_link.bw_bytes_s,
                disk_latency_s=self.kv.disk_link.latency_s,
                peer_in_bytes=self.swap.pending_peer_in_bytes(),
                peer_out_bytes=self.swap.pending_peer_out_bytes(),
                peer_bw=self.kv.peer_link.bw_bytes_s,
                peer_latency_s=self.kv.peer_link.latency_s),
            min_interval=min_i, max_interval=max_i,
            idle=idle if idle is not None else self._active_batch() == 0
            and not self.scheduler.has_work(),
            kv_bytes_per_iter=kv_stream + kv_out,
            # pending handoff traffic: its own link, but the fleet budget
            # arbitrates it alongside weight prefetch (FleetLinkBudget)
            peer_bytes_per_iter=(self.swap.pending_peer_in_bytes()
                                 + self.swap.pending_peer_out_bytes()))

    # ------------------------------------------------------------ autotune --
    def _resize_out_bytes(self, interval: int) -> float:
        """Demotion write-back bytes a switch to ``interval`` would charge
        to the next iteration's link budget (KV pages displaced from the
        shrinking device pool, host-ward)."""
        if interval == self.interval:
            return 0.0
        weight_free = max(int(self.ecfg.hbm_budget_bytes
                              - self._plan(interval)
                              .device_bytes(self.unit_bytes)), 0)
        new_pages = weight_free // self.kv.page_bytes
        return float(max(self.kv.device.used_pages - new_pages, 0)
                     * self.kv.page_bytes)

    def _batch_capacity(self, interval: int) -> int:
        """Decode slots the KV capacity at ``interval`` could sustain for
        the current population, as a packing plan over the allocator's
        ACTUAL free frames (device headroom at that interval, free host
        frames, and reclaimable keep-alive cache pages): residents keep
        their claimed frames and charge only their remaining growth, then
        waiting requests' full footprints pack greedily smallest-first.
        The tuner's backlog mode trades this against the interval's
        iteration time. (Replaces the average-footprint estimate, which
        counted the WHOLE host pool — pages already claimed by parked
        requests included — and over-admitted under host pressure.)"""
        weight_free = max(int(self.ecfg.hbm_budget_bytes
                              - self._plan(interval)
                              .device_bytes(self.unit_bytes)), 0)
        dev_pages = weight_free // self.kv.page_bytes
        free_pages = (max(dev_pages - self.kv.device.used_pages, 0)
                      + self.kv.host.free_pages
                      + self.kv.reclaimable_host_pages())
        residents = ([r for r in self.slot_req if r is not None]
                     + list(self.scheduler.preempted))
        if not residents and not self.queue:
            return self.ecfg.max_batch

        def need_pages(r: Request) -> int:
            return self.kv.device.pages_for(r.prompt_len + r.max_new_tokens)

        fit = len(residents)
        growth = 0
        for r in residents:
            have = len(self.kv.refs(r.rid)) \
                + len(self.kv.reserves_of(r.rid))
            growth += max(need_pages(r) - have, 0)
        budget = free_pages - growth
        for need in sorted(need_pages(r) for r in self.queue):
            if need > budget:
                break
            budget -= need
            fit += 1
        return int(max(1, min(self.ecfg.max_batch, fit)))

    def _tuner_gauges(self) -> TunerGauges:
        """Snapshot the runtime state the online tuner decides from — the
        same quantities the telemetry plane records per iteration."""
        batch = self._active_batch()
        # tightest budget over live slots AND every waiter: the scheduler's
        # admission pass scans the whole queue (plus parked requests), so
        # the tuner must pre-position for whichever of them it certifies
        # next, not just the population already decoding
        tpots = [r.tpot_slo_s for r in self.slot_req if r is not None]
        tpots += [r.tpot_slo_s for r in self.queue]
        tpots += [r.tpot_slo_s for r in self.scheduler.preempted]
        return TunerGauges(
            batch=batch,
            queue_depth=len(self.queue) + len(self.scheduler.preempted),
            min_interval=self._min_interval_now(),
            max_interval=self._max_interval_now(),
            num_units=self.num_units,
            times=self.times_fn(max(batch, 1), self.ecfg.max_seq, "decode"),
            kv_in_bytes=(self.swap.streamed_bytes(self._active_rids())
                         + self.swap.pending_in_bytes()),
            kv_out_bytes=self.swap.pending_out_bytes(),
            tpot_budget_s=min(tpots) if tpots else float("inf"),
            resize_out_bytes=self._resize_out_bytes,
            batch_capacity=self._batch_capacity,
            disk_in_bytes=self.swap.pending_disk_in_bytes(),
            disk_out_bytes=self.swap.pending_disk_out_bytes(),
            disk_bw=self.kv.disk_link.bw_bytes_s,
            disk_latency_s=self.kv.disk_link.latency_s,
            peer_in_bytes=self.swap.pending_peer_in_bytes(),
            peer_out_bytes=self.swap.pending_peer_out_bytes(),
            peer_bw=self.kv.peer_link.bw_bytes_s,
            peer_latency_s=self.kv.peer_link.latency_s)

    def _autotune_interval(self) -> None:
        """§5 online stage: let the tuner re-pick the interval for this
        iteration; on an executor refusal, ban the interval and re-plan
        (bounded — the candidate set only shrinks)."""
        gauges = self._tuner_gauges()
        banned: set[int] = set()
        for _ in range(self.num_units + 2):
            target = self.tuner.propose(gauges, self.interval, banned=banned)
            if target == self.interval or self.set_interval(target):
                return
            banned.add(target)

    def submit(self, req: Request) -> None:
        req.submitted_s = self.clock_s
        self.scheduler.submit(req)

    def _active_batch(self) -> int:
        return int(self.active.sum())

    def _view(self) -> SchedulerView:
        active = [ActiveInfo(req, slot)
                  for slot, req in enumerate(self.slot_req)
                  if req is not None and self.active[slot]]
        free_slots = [i for i in range(self.ecfg.max_batch)
                      if self.slot_req[i] is None]
        return SchedulerView(interval=self.interval, free_slots=free_slots,
                             active=active)

    def _admit(self) -> IterationPlan:
        """Plan one iteration and apply everything but the decode step:
        preemption write-backs, resume promotions, admissions (one-shot
        prefill for non-chunked ones). Chunk compute is applied by ``step``
        so its time rides the decode iteration."""
        plan = self.scheduler.plan(self._view())
        self.rejected.extend(plan.rejections)
        for req in plan.rejections:
            self.trace.event("reject", req.rid, self.clock_s,
                             reason=req.reject_reason)
        # data-plane order MUST follow planning order: resumes were planned
        # before preemptions, so a park's host destination may be the very
        # slot a resume promotion vacated — the resume must read its host
        # bytes before the park overwrites them
        self._apply_resumes(plan.resumes)
        self._apply_preemptions(plan.preemptions)
        for adm in plan.admissions:
            adm.req.admitted_s = self.clock_s
            self.trace.event("admit", adm.req.rid, self.clock_s,
                             slot=adm.slot, chunked=adm.chunked,
                             certified_ttft_s=adm.certified_ttft_s)
            if adm.chunked:
                adm.req.state = State.PREFILLING
                adm.req.slot = adm.slot
                self.slot_req[adm.slot] = adm.req
            else:
                self._prefill_into_slot(adm.req, adm.slot)
        return plan

    def _apply_preemptions(self, items: list[PlannedPreemption]) -> None:
        """Park victims: copy their device-resident pages into the host
        slots the scheduler claimed (BEFORE anything re-writes the freed
        frames — admissions in the same plan may reuse them), snapshot the
        decode cursor for a token-exact resume, and vacate the slot. The
        write-back bytes were charged by the scheduler
        (``swap.note_demotions``) and land on this iteration's link."""
        for it in items:
            req, slot = it.req, it.slot
            if it.migrations and self.kv.park_copy is None:
                # with a disk tier the parked bytes already moved in
                # planning order (see _park_page_copy)
                assert self.host_pool is not None
                ops.copy_pages_to_host(self.pool,
                                       [m.src_page for m in it.migrations],
                                       self.host_pool,
                                       [m.dst_page for m in it.migrations])
            req.state = State.PREEMPTED
            req.preempt_count += 1
            req.parked_at_s = self.clock_s
            self.trace.event("park", req.rid, self.clock_s, slot=slot)
            req.next_token = int(self.tokens[slot])
            req.resume_pos = int(self.pos[slot])
            req.slot = -1
            self.active[slot] = False
            self.slot_req[slot] = None

    def _apply_resumes(self, items: list[PlannedResume]) -> None:
        """Un-park: copy promoted pages back into their device frames and
        restore the decode cursor exactly where preemption snapshot it —
        the next decode step continues the token stream bit-for-bit.
        Promotion bytes were charged by the scheduler
        (``swap.note_promotions``)."""
        for it in items:
            req, slot = it.req, it.slot
            if it.migrations and self.kv.promote_copy is None:
                # with a disk tier the promotion bytes already moved in
                # planning order (see _promote_page_copy); copying again
                # here would re-read transit frames later stagings reused
                assert self.host_pool is not None
                self.pool = ops.copy_pages_from_host(
                    self.host_pool, [m.src_page for m in it.migrations],
                    self.pool, [m.dst_page for m in it.migrations])
            req.state = State.DECODING
            if req.parked_at_s is not None:
                req.preempt_stall_s += self.clock_s - req.parked_at_s
                req.parked_at_s = None
            self.trace.event("resume", req.rid, self.clock_s, slot=slot)
            req.slot = slot
            self.slot_req[slot] = req
            self.tokens[slot] = req.next_token
            self.pos[slot] = req.resume_pos
            self.active[slot] = True

    def _trace_footer(self) -> dict:
        """Counters snapshot the trace auditor cross-checks whole-trace
        conservation against (allocator + swap-scheduler cumulative totals
        minus what is still pending at export time)."""
        return {
            "page_bytes": self.kv.page_bytes,
            "clock_s": self.clock_s,
            # no copy-stage data plane in this port yet: nothing is staged
            "staged_issued_pages_total": 0,
            "staged_completed_pages_total": 0,
            "staged_inflight_pages": 0,
            "disk_direct_pages_total": self.kv.disk_direct_pages_total,
            "prefetch_pages_total": self.prefetch_pages_total,
            "disk_in_pages_total": self.kv.disk_in_pages_total,
            "disk_out_pages_total": self.kv.disk_out_pages_total,
            "pending_disk_in_pages": self.kv.pending_disk_in_pages,
            "pending_disk_out_pages": self.kv.pending_disk_out_pages,
            "noted_in_pages_total": self.swap.in_pages_noted_total,
            "noted_out_pages_total": self.swap.out_pages_noted_total,
            "pending_in_pages": self.swap._pending_in_pages,
            "pending_out_pages": self.swap._pending_out_pages,
            "promoted_pages_total": self.swap.promoted_pages_total,
            "cow_in_bytes_total": self.cow_in_bytes_total,
            "cow_out_bytes_total": self.cow_out_bytes_total,
            "interval_refusals_total": self.interval_refusals,
            "interval_switches_total": self.interval_switches,
            "idle_wait_total_s": self.idle_wait_total_s,
            "mig_in_bytes_total": self.mig_in_bytes_total,
            "mig_out_bytes_total": self.mig_out_bytes_total,
            "pending_mig_in_bytes": self.pending_mig_in_bytes,
            "pending_mig_out_bytes": self.pending_mig_out_bytes,
            "mig_wait_total_s": self.mig_wait_total_s,
            "pending_mig_wait_s": self.mig_wait_s,
            "n_migrated_in": self.n_migrated_in,
            "n_migrated_out": self.n_migrated_out,
            "peer_in_pages_total": self.kv.peer_in_pages_total,
            "peer_out_pages_total": self.kv.peer_out_pages_total,
            "pending_peer_in_pages": self.kv.pending_peer_in_pages,
            "pending_peer_out_pages": self.kv.pending_peer_out_pages,
            "handoff_in_bytes_total": self.handoff_in_bytes_total,
            "handoff_out_bytes_total": self.handoff_out_bytes_total,
            "n_handoff_in": self.n_handoff_in,
            "n_handoff_out": self.n_handoff_out,
            "n_finished": len(self.finished),
            "n_rejected": len(self.rejected),
            "n_active": sum(1 for r in self.slot_req if r is not None),
            "n_parked": len(self.scheduler.preempted),
        }

    def _greedy(self, req: Request, logits: np.ndarray) -> int:
        """The token ``req`` emits from ``logits`` (one place, so a
        cross-framework lockstep can teacher-force it)."""
        return int(np.argmax(logits))

    def _modeled_ttft(self, req: Request, host_spill_bytes: float) -> float:
        """Prefill latency: the spilled KV prefix is written back (d2h)
        through the link the weight prefetches share."""
        times = self.times_fn(1, req.prompt_len, "prefill")
        pre_i = max(self.rec["prefill"].lookup(req.ttft_slo_s, 1,
                                               req.prompt_len), 1)
        return iter_time_with_interval_kv(times, min(pre_i, NO_OFFLOAD),
                                          0.0, host_spill_bytes)

    # -------------------------------------------------------------- prefill --
    def _device_call(self, log: list[float], fn, *args, **kwargs):
        """Run ``fn``; on a GPU, append its stream time in ms to ``log``
        (CUDA events around the call, read after it completes: the time
        from the first queued operation to the last, host gaps included)."""
        if self.device.type != "cuda":
            return fn(*args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        log.append(start.elapsed_time(end))
        return out

    def _bucketed_prefill(self, tokens: np.ndarray, cache_len: int):
        """Run the offload-aware prefill over ``tokens``, shape-bucketed to
        one length (``max_seq``). Suffix padding is causally inert — masked
        softmax terms contribute exact 0.0 and the running-max flash combine
        is a no-op over all-masked tiles — and every GEMM sees the same
        shape, so a prefix's KV bits are identical no matter the prompt
        length it was computed under. That makes content-addressed KV reuse
        (prefix dedup, host prefix cache) bitwise-sound between requests of
        unequal length."""
        rt, params = self._rt()
        bucket = self.ecfg.max_seq
        s = int(len(tokens))
        padded = np.zeros(bucket, np.int32)
        padded[:s] = np.asarray(tokens, np.int32)
        inputs = {"tokens": torch.as_tensor(padded, device=self.device)[None]}
        return self._device_call(
            self.prefill_ms, rt.prefill, params, inputs, cache_len=bucket,
            last_pos=s - 1)

    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        req.state = State.PREFILLING
        req.slot = slot
        self.slot_req[slot] = req
        # prefill this request alone (chunked prefill routes through
        # _run_chunks instead; the paper separates phases). The prefill is
        # shape-bucketed to max_seq (see _bucketed_prefill); the page
        # scatter slices the merged caches back to the true prompt length.
        logits, caches1, _ = self._bucketed_prefill(req.prompt,
                                                    req.prompt_len)
        req.prefill_pos = req.prompt_len
        self.prefill_tokens_computed += req.prompt_len
        self._scatter_prefill_kv(req, caches1)
        # modeled prefill latency = TTFT (same formula admission checked):
        # only freshly spilled pages cost write-back — dedup'd host pages
        # are already resident
        ttft = self._modeled_ttft(req, self.kv.spill_writeback_bytes_of(
            req.rid))
        req.ttft_s = ttft
        self.trace.event("prefill", req.rid, self.clock_s, slot=slot,
                         dur_s=ttft)
        self.clock_s += ttft

        logits_np = logits[0].float().cpu().numpy()
        self.prefill_log.append((req, slot, logits_np))
        tok = self._greedy(req, logits_np)
        req.generated.append(tok)
        if req.done:
            # token budget exhausted at prefill (max_new_tokens <= 1): never
            # activate the slot — a decode step would write past the
            # allocated pages (into the shared null frame) and over-generate
            req.state = State.FINISHED
            self.finished.append(req)
            self.slot_req[slot] = None
            self.kv.free(req.rid)
            self.trace.event("finish", req.rid, self.clock_s, slot=slot,
                             at_prefill=True)
            return
        self.tokens[slot] = tok
        self.pos[slot] = req.prompt_len
        self.active[slot] = True
        req.state = State.DECODING

    def _scatter_prefill_kv(self, req: Request, caches1: Any,
                            n_tokens: int | None = None,
                            start_page: int = 0) -> None:
        """Land the prefilled KV in the page pools: device-tier pages go into
        the physical pool via one batched scatter, host-tier (spilled cold
        prefix) pages go straight into the pinned-host buffer. Pages the
        allocator mapped onto existing frames (prefix dedup) already hold
        this exact KV — scattering into them would clobber a sibling's live
        page, so they are skipped (that skip is the dedup bandwidth win).
        A chunked prefill passes ``n_tokens`` (the chunk's end position) and
        ``start_page``: only pages the chunk completed or started are
        written — earlier pages already landed with earlier chunks."""
        if n_tokens is None:
            n_tokens = req.prompt_len
        # per pattern position j: [R, 1, S, ...]
        merged = merge_stacked(caches1, self._plan(self.interval))
        # global layer order: unit-major, pattern-minor (u * P + j)
        shape = (self.cfg.num_layers, n_tokens, *self.page_shape[3:])
        k_all = torch.stack([m["self"]["k"][:, 0, :n_tokens] for m in merged],
                            dim=1).reshape(shape)
        v_all = torch.stack([m["self"]["v"][:, 0, :n_tokens] for m in merged],
                            dim=1).reshape(shape)
        vals = ops.pack_token_pages(k_all, v_all, self.ecfg.page_size,
                                    dtype=torch.bfloat16)
        refs = self.kv.refs(req.rid)
        deduped = set(self.kv.dedup_hit_pages(req.rid))
        dev_frames, dev_pages = [], []
        for i in range(start_page, vals.shape[0]):
            if i in deduped:
                continue
            r = refs[i]
            if r.tier == DEVICE:
                assert r.page < self.dev_cap, "LIFO high-water bound violated"
                dev_frames.append(r.page)
                dev_pages.append(i)
            else:
                # fresh allocations land on device or host only; disk-tier
                # hits were revived host-ward inside alloc (and are in the
                # deduped skip-set anyway)
                assert r.tier == HOST and self.host_pool is not None
                self.host_pool[r.page] = vals[i].cpu()
        if dev_frames:
            self.pool = ops.scatter_kv_pages(
                self.pool, dev_frames, vals[torch.as_tensor(
                    dev_pages, device=vals.device)])

    # ------------------------------------------------------- chunked prefill --
    def _prefill_seconds(self, tokens: int) -> float:
        """Modeled compute seconds of a prompt prefill up to ``tokens``
        (no-offload stack time; the weight stream already serves the decode
        iteration the chunk piggybacks on)."""
        if tokens <= 0:
            return 0.0
        return self.times_fn(1, tokens, "prefill").t_iter_no_offload_s

    def _run_chunk_incremental(self, ch: PrefillChunk) -> np.ndarray | None:
        """Incremental chunk compute: the chunk's C tokens run through the
        paged chunk-prefill kernel, attending the request's RESIDENT paged
        KV (earlier chunks' pages stay in the pool; host-tier pages stream
        through the slab and the pages the chunk writes stream back) —
        O(C * prefix) work instead of the recompute path's O(end). Returns
        the chunk's last-position logits, or None to fall back to the
        recompute path (unsupported page placement or slab overflow)."""
        req = ch.req
        page = self.ecfg.page_size
        refs = self.kv.refs(req.rid)
        n_pages = -(-ch.end // page)
        if n_pages > len(refs) or n_pages > self.nb:
            return None
        bt = np.full((self.nb,), self.null_frame, np.int32)
        stream_src: list[int] = []
        stream_dst: list[int] = []
        writeback: list[tuple[int, int]] = []   # (host slot, slab frame)
        slab_next = self.slab_base
        for i in range(n_pages):
            r = refs[i]
            if r.tier == DEVICE:
                bt[i] = r.page
            elif r.tier == HOST:
                if slab_next >= self.null_frame:
                    return None           # slab overflow: recompute instead
                stream_src.append(r.page)
                stream_dst.append(slab_next)
                bt[i] = slab_next
                if i >= ch.start // page:   # chunk writes into this page
                    writeback.append((r.page, slab_next))
                slab_next += 1
            else:
                return None               # disk-resident page: recompute
        if stream_src:
            self.pool = ops.copy_pages_from_host(
                self.host_pool, stream_src, self.pool, stream_dst)
            self.chunk_pages_streamed += len(stream_src)
        toks = np.arange(ch.start, ch.end)
        wf = bt[toks // page]
        wo = (toks % page).astype(np.int32)
        rt, params = self._rt()
        dev = lambda a: torch.as_tensor(a, device=self.device)
        logits, self.pool = self._device_call(
            self.chunk_ms, rt.paged_prefill_chunk, params,
            dev(req.prompt[ch.start:ch.end].astype(np.int32)), ch.start,
            self.pool, dev(bt), ch.end, dev(wf), dev(wo))
        if writeback:
            # the decode step of this iteration reuses the slab from
            # slab_base: the chunk's dirty pages go home before it returns
            got = ops.gather_kv_pages(self.pool,
                                      [f for _, f in writeback]).cpu()
            for (host_slot, _), val in zip(writeback, got):
                self.host_pool[host_slot] = val
        self.prefill_tokens_computed += ch.end - ch.start
        return logits[0].float().cpu().numpy()

    def _run_chunks(self, chunks: list[PrefillChunk]
                    ) -> tuple[float, list[tuple[PrefillChunk, np.ndarray]]]:
        """Compute + scatter this iteration's prefill chunks. By default
        the real compute recomputes the prefix (prefill over
        ``prompt[:end]`` — causal attention makes the chunk's KV
        bit-identical to a one-shot prefill, which is what keeps chunking
        numerically invisible) — quadratic real work across the schedule.
        With ``incremental_prefill`` the chunk kernel attends only the new
        queries against resident paged KV, making real compute match the
        *modeled* chunk cost: the incremental stack time T(end) - T(start),
        charged on top of the decode iteration it rides.
        Returns (modeled chunk seconds, final-chunk logits)."""
        t = 0.0
        finals: list[tuple[PrefillChunk, np.ndarray]] = []
        for ch in chunks:
            req = ch.req
            page = self.ecfg.page_size
            logits_np = None
            if self.ecfg.incremental_prefill:
                logits_np = self._run_chunk_incremental(ch)
            if logits_np is None:
                logits, caches1, _ = self._bucketed_prefill(
                    req.prompt[:ch.end], ch.end)
                self._scatter_prefill_kv(req, caches1, n_tokens=ch.end,
                                         start_page=ch.start // page)
                self.prefill_tokens_computed += ch.end
                logits_np = logits[0].float().cpu().numpy()
            # a chunk that lands on spilled (fresh host-tier) pages writes
            # them over the same link as everything else: charge the d2h
            # bytes like the one-shot path does via _modeled_ttft. Dedup'd
            # host hits are already resident and cost nothing.
            refs = self.kv.refs(req.rid)
            deduped = set(self.kv.dedup_hit_pages(req.rid))
            n_host_written = sum(
                1 for i in range(ch.start // page, -(-ch.end // page))
                if i not in deduped and i < len(refs)
                and refs[i].tier == HOST)
            if n_host_written:
                # noted AFTER the scheduler stamped certified_dt: these
                # bytes surface as kv_out in excess of the plan's certified
                # total, which the trace auditor allows as serialization
                # slack on top of the certified bound
                self.swap.note_demotions(n_host_written)
            req.prefill_pos = ch.end
            inc = max(self._prefill_seconds(ch.end)
                      - self._prefill_seconds(ch.start), 0.0)
            t += inc
            self.trace.event("chunk", req.rid, self.clock_s, slot=ch.slot,
                             dur_s=inc, start=ch.start, end=ch.end,
                             final=ch.final)
            if ch.final:
                finals.append((ch, logits_np))
        return t, finals

    def _finish_chunks(self, chunks: list[PrefillChunk],
                       finals: list[tuple[PrefillChunk, np.ndarray]],
                       dt: float) -> list[int]:
        """Per-chunk TTFT accounting: every in-flight chunked prefill
        absorbs this iteration's latency; a final chunk closes TTFT, emits
        the request's first token, and activates the slot for the next
        decode step. Returns rids finished at prefill (token budget <= 1)."""
        done: list[int] = []
        for ch in chunks:
            ch.req.ttft_accum_s += dt
        for ch, logits_np in finals:
            req = ch.req
            req.ttft_s = req.ttft_accum_s
            self.prefill_log.append((req, ch.slot, logits_np))
            tok = self._greedy(req, logits_np)
            req.generated.append(tok)
            if req.done:
                # token budget exhausted at prefill: never activate the slot
                req.state = State.FINISHED
                self.finished.append(req)
                self.slot_req[ch.slot] = None
                self.kv.free(req.rid)
                done.append(req.rid)
                self.trace.event("finish", req.rid, self.clock_s,
                                 slot=ch.slot, at_prefill=True)
                continue
            self.tokens[ch.slot] = tok
            self.pos[ch.slot] = req.prompt_len
            self.active[ch.slot] = True
            req.state = State.DECODING
        return done

    # ---------------------------------------------------------------- decode --
    def _build_iteration_tables(self) -> tuple:
        """Per-iteration kernel inputs from the allocator refs: block tables
        and context lengths per slot, the new token's write frame/offset, the
        host pages to stream into the slab, and the dirty streamed page (if
        the write lands on a host-resident page) to write back afterwards."""
        b, nb, page = self.ecfg.max_batch, self.nb, self.ecfg.page_size
        bt = np.full((b, nb), self.null_frame, np.int32)
        cl = np.zeros((b,), np.int32)
        wf = np.full((b,), self.null_frame, np.int32)
        wo = np.zeros((b,), np.int32)
        stream_src: list[int] = []      # host pool slots
        stream_dst: list[int] = []      # slab frames
        writeback: list[tuple[int, int]] = []   # (host slot, slab frame)
        slab_of: dict[int, int] = {}    # host slot -> slab frame (dedup:
        slab_next = self.slab_base      # a shared host page streams ONCE)
        for slot in range(b):
            req = self.slot_req[slot]
            if not self.active[slot] or req is None:
                continue
            refs = self.kv.refs(req.rid)
            assert len(refs) <= nb
            for i, r in enumerate(refs):
                if r.tier == DEVICE:
                    assert r.page < self.dev_cap, \
                        "LIFO high-water bound violated"
                    bt[slot, i] = r.page
                else:
                    # only host pages stream through the slab: an ACTIVE
                    # request must never hold disk-tier pages (resume
                    # stages disk->host before the slot re-activates)
                    assert r.tier == HOST, \
                        f"active rid {req.rid} holds a {r.tier} page"
                    if r.page not in slab_of:
                        slab_of[r.page] = slab_next
                        stream_src.append(r.page)
                        stream_dst.append(slab_next)
                        slab_next += 1
                    bt[slot, i] = slab_of[r.page]
            p = int(self.pos[slot])
            cl[slot] = p + 1                    # includes the token written now
            wpi = p // page
            wf[slot] = bt[slot, wpi]
            wo[slot] = p % page
            if wf[slot] >= self.slab_base and wf[slot] != self.null_frame:
                # decode writes into a streamed (host-resident) page: the
                # dirty slab frame must be written back or the token is lost
                writeback.append((refs[wpi].page, int(wf[slot])))
        assert slab_next <= self.null_frame
        return bt, cl, wf, wo, stream_src, stream_dst, writeback

    def _resolve_cow_writes(self) -> tuple[float, float]:
        """Copy-on-write pre-pass: before the decode kernel writes this
        iteration's token KV, every slot whose write page is still shared
        moves onto its pre-claimed private frame (``kv.prepare_write``), and
        the page bytes follow through the data plane. Runs after promotions
        (so the moves see final tiers) and before the block tables are
        built. A sibling's page bytes are never touched — that is the
        property the kernel-level COW tests pin down.

        Returns (h2d_bytes, d2h_bytes) of the CROSS-TIER copies so the
        caller charges them to this iteration's link budget — same-pool
        copies never touch the host link and cost nothing in the SLO
        model."""
        page = self.ecfg.page_size
        moves = []
        for slot in range(self.ecfg.max_batch):
            req = self.slot_req[slot]
            if not self.active[slot] or req is None:
                continue
            moves.extend(self.kv.prepare_write(req.rid,
                                               int(self.pos[slot]) // page))
        if not moves:
            return 0.0, 0.0
        self.cow_events += len(moves)
        cow_in = cow_out = 0.0
        dd_src: list[int] = []
        dd_dst: list[int] = []
        for m in moves:
            src, dst = m.src, m.dst
            if src.tier == DEVICE and dst.tier == DEVICE:
                dd_src.append(src.page)
                dd_dst.append(dst.page)
            elif src.tier == HOST and dst.tier == HOST:
                self.host_pool[dst.page] = self.host_pool[src.page]
            elif src.tier == HOST:
                self.pool = ops.copy_pages_from_host(
                    self.host_pool, [src.page], self.pool, [dst.page])
                cow_in += self.kv.page_bytes
            else:
                ops.copy_pages_to_host(self.pool, [src.page],
                                       self.host_pool, [dst.page])
                cow_out += self.kv.page_bytes
        if dd_src:
            self.pool = ops.copy_pages_on_device(self.pool, dd_src, dd_dst)
        return cow_in, cow_out

    def step(self, peers: list["ServingEngine"] | None = None,
             link_bw: float | None = None) -> None:
        """One inference iteration: coordinate -> plan -> apply (preempt /
        resume / admit / chunk) -> decode all active slots -> report the
        outcome to the scheduler."""
        self.prefill_log = []
        self.last_decode = None
        t_start = self.clock_s
        idle_wait = self.idle_wait_s
        self.idle_wait_s = 0.0
        mig_wait = self.mig_wait_s
        mig_in_b = self.pending_mig_in_bytes
        mig_out_b = self.pending_mig_out_bytes
        self.mig_wait_s = 0.0
        self.pending_mig_in_bytes = 0.0
        self.pending_mig_out_bytes = 0.0
        if peers is not None and link_bw is not None:
            engines = [self] + list(peers)
            insts = [e.instance_state() for e in engines]
            # bounded re-plan: an executor may refuse its assignment (host
            # pool cannot absorb the demoted KV) — clamp that instance's
            # ceiling to the interval it actually holds and coordinate
            # again, instead of silently running a plan nobody applied
            for _ in range(len(engines) + 1):
                res = coordinate(insts, link_bw)
                if not res.ok:
                    break
                refused = False
                for eng, inst in zip(engines, insts):
                    if not eng.set_interval(res.intervals[eng.name]):
                        inst.max_interval = min(inst.max_interval,
                                                eng.interval)
                        refused = True
                if not refused:
                    break
        elif self.tuner is not None:
            self._autotune_interval()
        elif self.interval == 0:
            self.set_interval(NO_OFFLOAD)

        fin0 = len(self.finished)
        plan = self._admit()
        # one-shot prefills emit a first token each and may finish their
        # request outright (token budget <= 1): count them in the outcome
        # like the chunked finals are counted
        prefill_tokens = sum(1 for adm in plan.admissions if not adm.chunked)
        prefill_finished = [r.rid for r in self.finished[fin0:]]
        # the applied plan must agree with the executor's resulting state —
        # the typed contract is checked, not decorative
        assert plan.target_interval == self.interval, \
            "plan was built against a stale interval"
        assert plan.decode_slots == [s for s in range(self.ecfg.max_batch)
                                     if self.active[s]], \
            "scheduler decode_slots diverge from executor slot state"
        self.host_kv_peak_pages = max(self.host_kv_peak_pages,
                                      self.kv.host.used_pages)
        self.device_pages_peak = max(self.device_pages_peak,
                                     self.kv.device.used_pages)
        self.disk_kv_peak_pages = max(self.disk_kv_peak_pages,
                                      self.kv.disk.used_pages)
        chunk_s, finals = self._run_chunks(plan.chunks)
        if self._active_batch() == 0:
            # no decode this iteration; chunk compute still advances the
            # clock and the chunked requests' TTFT accrual
            if plan.chunks:
                self.clock_s += chunk_s
                done = self._finish_chunks(plan.chunks, finals, chunk_s)
                dt_rec, finished = chunk_s, prefill_finished + done
                self.scheduler.note_outcome(IterationOutcome(
                    dt_s=chunk_s, finished_rids=finished,
                    tokens_emitted=prefill_tokens + len(finals),
                    chunks_run=len(plan.chunks),
                    preemptions=len(plan.preemptions),
                    resumes=len(plan.resumes)))
            else:
                dt_rec, finished = 0.0, prefill_finished
                self.scheduler.note_outcome(IterationOutcome(
                    dt_s=0.0, finished_rids=prefill_finished,
                    tokens_emitted=prefill_tokens,
                    preemptions=len(plan.preemptions),
                    resumes=len(plan.resumes)))
            self.trace.add_iteration(IterationRecord(
                index=len(self.trace.iterations), t_start_s=t_start,
                t_end_s=self.clock_s, dt_s=dt_rec, interval=self.interval,
                decode_batch=0, n_chunks=len(plan.chunks),
                admitted=[a.req.rid for a in plan.admissions],
                rejected=[r.rid for r in plan.rejections],
                parked=[p.req.rid for p in plan.preemptions],
                resumed=[r.req.rid for r in plan.resumes],
                finished=finished, chunk_s=dt_rec,
                idle_wait_s=idle_wait, mig_wait_s=mig_wait,
                mig_in_bytes=mig_in_b, mig_out_bytes=mig_out_b,
                certified_dt_s=plan.certified_dt_s,
                occupancy=self.kv.occupancy(),
                reserve_pages=self.kv.n_reserve_frames()))
            return
        # KV tier activity of this iteration: promote host pages into freed
        # device frames, stream the rest in for attention, write back any
        # pending demotions (incl. preemption parks) and charge resume
        # promotions. Promotion is never a traffic spike: a promoted page's
        # one-time copy replaces its recurring streamed copy.
        pend_in_b = self.swap.pending_in_bytes()
        pend_out_b = self.swap.pending_out_bytes()
        pdisk_in_pages = self.kv.pending_disk_in_pages
        pdisk_out_pages = self.kv.pending_disk_out_pages
        ppeer_in_pages = self.kv.pending_peer_in_pages
        ppeer_out_pages = self.kv.pending_peer_out_pages
        sp = self.swap.plan_iteration(self._active_rids())
        if sp.promotions:
            assert self.host_pool is not None
            self.pool = ops.copy_pages_from_host(
                self.host_pool, [m.src_page for m in sp.promotions],
                self.pool, [m.dst_page for m in sp.promotions])
        cow_in, cow_out = self._resolve_cow_writes()
        if cow_in or cow_out:
            # a cross-tier COW moved a write page between tiers, changing
            # which pages actually stream through the slab this iteration:
            # re-derive the streamed component from the post-COW refs so
            # the charged bytes equal the gathers the tables will issue,
            # then add the one-off COW copies themselves
            streamed_now = self.swap.streamed_bytes(self._active_rids())
            sp.kv_in_bytes += streamed_now - sp.streamed_bytes
            sp.streamed_bytes = streamed_now
        sp.kv_in_bytes += cow_in
        sp.kv_out_bytes += cow_out
        self.cow_in_bytes_total += cow_in
        self.cow_out_bytes_total += cow_out
        # bytes the scheduler could not have certified at plan time: any
        # excess of actual PCIe traffic over the totals the certified-dt
        # stamp was derived from. This uniformly covers COW copies (and the
        # stream growth they cause), chunk host-spill write-backs, and pages
        # a same-plan one-shot prefill spilled to host that now stream into
        # this very decode.
        uncert_in = max(sp.kv_in_bytes - plan.certified_kv_in_bytes, 0.0)
        uncert_out = max(sp.kv_out_bytes - plan.certified_kv_out_bytes, 0.0)
        rt, params = self._rt()
        bt, cl, wf, wo, stream_src, stream_dst, writeback = \
            self._build_iteration_tables()
        if stream_src:
            self.streamed_pages_peak = max(self.streamed_pages_peak,
                                           len(stream_src))
            self.pool = ops.copy_pages_from_host(self.host_pool, stream_src,
                                                 self.pool, stream_dst)
        tokens_in, pos_in = self.tokens.copy(), self.pos.copy()
        dev = lambda a: torch.as_tensor(a, device=self.device)
        logits, self.pool = self._device_call(
            self.decode_ms, rt.paged_decode_step, params, dev(tokens_in),
            dev(pos_in), self.pool, dev(bt), dev(cl), dev(wf), dev(wo))
        logits = logits.float().cpu().numpy()
        if writeback:
            got = ops.gather_kv_pages(self.pool,
                                      [f for _, f in writeback]).cpu()
            for (host_slot, _), val in zip(writeback, got):
                self.host_pool[host_slot] = val
        self.last_decode = {"tokens": tokens_in, "pos": pos_in,
                            "active": self.active.copy(), "logits": logits}

        times = self.times_fn(self._active_batch(), self.ecfg.max_seq,
                              "decode")
        # piggybacked chunk compute rides the same iteration: its stack time
        # adds to the latency every active request pays this step; NVMe
        # traffic (park-to-disk demotions, resume stagings, cache revivals)
        # gets the disk link's own term — it never rides the PCIe budget
        bd = iter_time_breakdown_kv(
            times, self.interval, sp.kv_in_bytes, sp.kv_out_bytes,
            disk_in_bytes=sp.disk_in_bytes,
            disk_out_bytes=sp.disk_out_bytes,
            disk_bw=self.kv.disk_link.bw_bytes_s,
            disk_latency_s=self.kv.disk_link.latency_s,
            peer_in_bytes=sp.peer_in_bytes,
            peer_out_bytes=sp.peer_out_bytes,
            peer_bw=self.kv.peer_link.bw_bytes_s,
            peer_latency_s=self.kv.peer_link.latency_s)
        dt = bd.total_s + chunk_s
        self.clock_s += dt
        decode_reqs = [(slot, self.slot_req[slot])
                       for slot in range(self.ecfg.max_batch)
                       if self.active[slot]
                       and self.slot_req[slot] is not None]

        finished_rids: list[int] = list(prefill_finished)
        tokens_out = prefill_tokens
        for slot in range(self.ecfg.max_batch):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            if req is None:
                continue
            tok = self._greedy(req, logits[slot])
            req.generated.append(tok)
            req.tpot_s.append(dt)
            tokens_out += 1
            self.tokens[slot] = tok
            self.pos[slot] += 1
            if req.done:
                req.state = State.FINISHED
                self.finished.append(req)
                self.active[slot] = False
                self.slot_req[slot] = None
                self.kv.free(req.rid)
                finished_rids.append(req.rid)
                self.trace.event("finish", req.rid, self.clock_s, slot=slot)
        finished_rids += self._finish_chunks(plan.chunks, finals, dt)
        tokens_out += len(finals)
        self.scheduler.note_outcome(IterationOutcome(
            dt_s=dt, finished_rids=finished_rids, tokens_emitted=tokens_out,
            chunks_run=len(plan.chunks), preemptions=len(plan.preemptions),
            resumes=len(plan.resumes)))
        self.trace.add_iteration(IterationRecord(
            index=len(self.trace.iterations), t_start_s=t_start,
            t_end_s=self.clock_s, dt_s=dt, interval=self.interval,
            decode_batch=len(decode_reqs), n_chunks=len(plan.chunks),
            admitted=[a.req.rid for a in plan.admissions],
            rejected=[r.rid for r in plan.rejections],
            parked=[p.req.rid for p in plan.preemptions],
            resumed=[r.req.rid for r in plan.resumes],
            finished=finished_rids,
            kv_in_bytes=sp.kv_in_bytes, kv_out_bytes=sp.kv_out_bytes,
            streamed_bytes=sp.streamed_bytes,
            promoted_bytes=len(sp.promotions) * self.kv.page_bytes,
            pending_in_bytes=pend_in_b, pending_out_bytes=pend_out_b,
            cow_in_bytes=cow_in, cow_out_bytes=cow_out,
            uncertified_in_bytes=uncert_in,
            uncertified_out_bytes=uncert_out,
            certified_kv_in_bytes=plan.certified_kv_in_bytes,
            certified_kv_out_bytes=plan.certified_kv_out_bytes,
            disk_in_bytes=sp.disk_in_bytes,
            disk_out_bytes=sp.disk_out_bytes,
            disk_in_pages=pdisk_in_pages, disk_out_pages=pdisk_out_pages,
            peer_in_bytes=sp.peer_in_bytes,
            peer_out_bytes=sp.peer_out_bytes,
            peer_in_pages=ppeer_in_pages, peer_out_pages=ppeer_out_pages,
            compute_s=bd.compute_s, kv_in_s=bd.kv_in_s,
            kv_out_s=bd.kv_out_s, stall_s=bd.stall_s, pcie_s=bd.pcie_s,
            disk_s=bd.disk_s, peer_s=bd.peer_s, chunk_s=chunk_s,
            model_dt_s=bd.total_s,
            idle_wait_s=idle_wait, mig_wait_s=mig_wait,
            mig_in_bytes=mig_in_b, mig_out_bytes=mig_out_b,
            link_bw_bytes_s=link_bandwidth(times),
            certified_dt_s=plan.certified_dt_s,
            occupancy=self.kv.occupancy(),
            reserve_pages=self.kv.n_reserve_frames(),
            gauges=[SlotGauge(rid=req.rid, slot=slot,
                              tpot_slo_s=req.tpot_slo_s,
                              headroom_s=req.tpot_slo_s - dt)
                    for slot, req in decode_reqs]))

    def run(self, requests: list[Request], max_iters: int = 10_000,
            peers=None, link_bw=None, submit_all: bool = False) -> dict:
        """Serve ``requests`` to completion on the modeled clock.

        By default the arrival process is honored: a request stays invisible
        to the scheduler until ``clock_s`` reaches its ``arrival_s``, and
        when the engine drains before the next arrival, the idle wait
        advances the clock to it (stamped as ``idle_wait_s`` on the next
        iteration record so the trace still tiles). ``queue_delay_s`` is
        then measured from arrival, not from submission. ``submit_all=True``
        is the compat path: everything submits at the current clock exactly
        as before arrivals were honored (bitwise-identical traces for the
        differential suites; also the default behavior for traces whose
        ``arrival_s`` are all 0)."""
        if submit_all:
            pending: list[Request] = []
            for r in requests:
                self.submit(r)
        else:
            pending = sorted(requests, key=lambda r: r.arrival_s)
        it = 0
        n_pend = 0                     # consumed prefix of ``pending``
        while True:
            while n_pend < len(pending) \
                    and pending[n_pend].arrival_s <= self.clock_s:
                req = pending[n_pend]
                n_pend += 1
                self.submit(req)
                # queueing delay counts from the arrival process, not from
                # the iteration boundary the request became visible at
                req.submitted_s = max(req.arrival_s, 0.0)
            if not (self.scheduler.has_work() or self._active_batch() > 0):
                if n_pend >= len(pending):
                    break
                nxt = pending[n_pend].arrival_s
                if nxt > self.clock_s:          # idle: jump to next arrival
                    self.idle_wait_s += nxt - self.clock_s
                    self.idle_wait_total_s += nxt - self.clock_s
                    self.clock_s = nxt
                continue
            if it >= max_iters:
                break
            self.step(peers=peers, link_bw=link_bw)
            it += 1
        done = [r.metrics() for r in self.finished]
        total_tokens = sum(m["tokens"] for m in done)
        delays = [m["queue_delay_s"] for m in done]
        st = self.scheduler.stats
        stalls = [m["preempt_stall_s"] for m in done]
        return {
            "finished": len(self.finished),
            "rejected": len(self.rejected),
            "tokens": total_tokens,
            "wall_modeled_s": self.clock_s,
            "throughput_tok_s": total_tokens / self.clock_s
            if self.clock_s > 0 else 0.0,
            "slo_ok": all(m["ttft_ok"] and m["tpot_ok"] for m in done),
            "preemptions": st["preemptions"],
            "resumes": st["resumes"],
            "disk_demotions": st["disk_demotions"],
            "disk_stagings": st["disk_stagings"],
            "handoffs_in": self.n_handoff_in,
            "handoffs_out": self.n_handoff_out,
            "prefetch_pages": self.prefetch_pages_total,
            "disk_direct_pages": self.kv.disk_direct_pages_total,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "preempt_stall_max_s": max(stalls) if stalls else 0.0,
            "chunked_prefill_iters": st["chunked_prefill_iters"],
            "queue_delay_p99_s": summarize_latency(delays)["p99_s"],
            "queue_delay": summarize_latency(delays),
            "ttft": summarize_latency([m["ttft_s"] for m in done]),
            "tpot": summarize_latency([t for r in self.finished
                                       for t in r.tpot_s]),
            "link_bytes": self.trace.totals(),
            # arrival-process accounting: with arrivals honored, the first
            # admission can never precede the first arrival on the modeled
            # clock (fig19's harness claim); idle_wait_s is the drained-
            # engine time run() skipped to the next arrival
            "first_arrival_s": (min(r.arrival_s for r in requests)
                                if requests else None),
            "first_admit_s": min((e.t_s for e in self.trace.events
                                  if e.kind == "admit"), default=None),
            "idle_wait_s": self.idle_wait_total_s,
            "arrivals_honored": not submit_all,
            # interval policy telemetry (coordinator / online tuner)
            "interval_switches": self.interval_switches,
            "interval_refusals": self.interval_refusals,
            "autotune": ({"lifts": self.tuner.lifts,
                          "retreats": self.tuner.retreats,
                          "refusals": self.tuner.refusals}
                         if self.tuner is not None else None),
            "per_request": done,
        }
