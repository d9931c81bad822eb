"""Scheduling policy for the serving engine: per-iteration plans.

The engine used to fuse policy and execution — ``_admit``/``_spill_admit``/
``_prefill_into_slot``/``step`` all mutated shared slot state, so scheduling
policies (preempt-to-host, chunked prefill) could not land without touching
the data plane. This module is the policy half of that split:

  * ``Scheduler`` owns the request queue, the preempted set, and slot
    assignment. Once per engine iteration it emits an ``IterationPlan`` —
    admissions, prefill chunks, preemptions, resumes, decode slots — from a
    ``SchedulerView`` snapshot of executor state.
  * ``ServingEngine`` (serving.engine) is the executor: it applies the plan
    (page copies, prefill compute + scatter, the paged decode kernel, the
    modeled clock) and reports an ``IterationOutcome`` back via
    ``note_outcome``.

Division of labour, vLLM-style: the scheduler owns the *accounting plane* —
it calls ``TieredKVAllocator.alloc/park/resume`` during planning so each
decision sees the pool state its predecessors left (admission N+1 must see
admission N's pages, an admission after a preemption must see the freed
frames). The executor owns the *data plane*: every physical page byte moves
when the plan is applied, in plan order (park write-backs land before any
freed frame is re-written).

Policies shipped on the contract:

  * **FIFO with whole-queue scan** (default): a memory-infeasible request no
    longer head-of-line blocks the queue — later requests that fit are
    admitted this iteration; the skipped request retries next iteration.
    SLO-infeasible and over-length requests are still rejected outright.
  * **Preempt-to-host** (``SchedulerConfig.preemption``): when a queued
    request cannot be admitted even via host spill, an active victim's
    entire KV is parked on the host tier (``TieredKVAllocator.park`` —
    frame-wise, so shared prefix pages a live sibling still uses don't
    move) and the request takes its place. Parked requests resume — token
    exactly — with priority over new admissions, once a slot is free and
    their streaming/promotion traffic fits the TPOT budget; resume copy
    bytes are charged to the link like any other KV traffic.
  * **Chunked prefill** (``SchedulerConfig.prefill_chunk_tokens``): long
    prompts prefill in page-aligned chunks piggybacked on decode iterations
    instead of stalling the batch; TTFT accrues per chunk.
  * **Disk-tier demotion** (three-tier allocator with ``disk_bytes > 0``):
    under host pressure, instead of refusing a park (or evicting prefix
    cache), the HOST pages of long-parked preempted requests — oldest park
    first, never frames an active sibling streams — retire to the NVMe
    tier (``TieredKVAllocator.demote_to_disk``), and resume stages them
    disk->host->device. NVMe traffic is charged to the disk link's own
    term of ``iter_time_with_interval_kv`` in every feasibility check; it
    never rides the TPOT-critical PCIe budget unmodeled.

With both policies off, the plans preserve the fused engine's admission
semantics up to two deliberate, always-on fixes shipped with the split —
the whole-queue FIFO scan (no head-of-line starvation) and the TPOT
cross-check of existing link traffic on the device admission path. On the
existing differential traces (loose SLOs, homogeneous queues) both fixes
are no-ops, and the suite locksteps the scheduler-driven engine against
the frozen dense reference on the PR-2/PR-3 traces unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.interval import NO_OFFLOAD, iter_time_with_interval_kv
from repro_torch.serving.kv_offload import (HOST, Migration, SwapScheduler,
                                      TieredKVAllocator)
from repro_torch.serving.request import Request, State


@dataclasses.dataclass
class SchedulerConfig:
    # Preempt-to-host: park an active victim's whole KV on the host tier to
    # unblock an admission the wait-only policy would stall on.
    preemption: bool = False
    # Chunked prefill: > 0 enables; rounded up to a page multiple so chunk
    # boundaries align with KV pages. 0 = one-shot prefill at admission
    # (the legacy path the differential suite locksteps).
    prefill_chunk_tokens: int = 0
    # Queue policy. "fifo" is the only built-in: arrival order with a
    # whole-queue scan (memory-infeasible requests are skipped, not blocking).
    policy: str = "fifo"


@dataclasses.dataclass
class ActiveInfo:
    """One decoding slot as the scheduler sees it."""
    req: Request
    slot: int

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def tpot_slo_s(self) -> float:
        return self.req.tpot_slo_s

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.req.generated)


@dataclasses.dataclass
class SchedulerView:
    """Read-only snapshot of executor state for one planning pass."""
    interval: int
    free_slots: list[int]          # slots with no request installed
    active: list[ActiveInfo]       # decoding slots (not prefilling ones)


@dataclasses.dataclass
class PlannedAdmission:
    req: Request
    slot: int
    # KV accounting already performed by the scheduler (alloc); the executor
    # runs prefill compute + scatter. chunked=True defers the compute to
    # PrefillChunk entries instead of a one-shot prefill.
    chunked: bool = False
    # TTFT the admission check certified (ttft_model under the spill
    # write-back claimed at alloc time); None for chunked admissions, whose
    # TTFT accrues across the iterations their chunks ride. The trace
    # auditor checks observed TTFT against this bound.
    certified_ttft_s: float | None = None


@dataclasses.dataclass
class PrefillChunk:
    """Prefill tokens [start, end) of ``req`` this iteration, piggybacked on
    the decode step. ``start`` is page-aligned; the final chunk ends at the
    prompt length and emits the request's first token."""
    req: Request
    slot: int
    start: int
    end: int

    @property
    def final(self) -> bool:
        return self.end >= self.req.prompt_len


@dataclasses.dataclass
class PlannedPreemption:
    req: Request
    slot: int
    migrations: list[Migration]    # accounting moves already applied


@dataclasses.dataclass
class PlannedResume:
    req: Request
    slot: int
    migrations: list[Migration]    # host->device promotions already applied


@dataclasses.dataclass
class IterationPlan:
    """What the executor must apply this iteration, in PLANNING order:
    resumes first (their promotion copies must read host slots before a
    later-planned park reuses them), then preemption write-backs (they
    vacate device frames admissions may re-write), then admissions, prefill
    chunks, and the decode step."""
    target_interval: int
    preemptions: list[PlannedPreemption] = dataclasses.field(
        default_factory=list)
    resumes: list[PlannedResume] = dataclasses.field(default_factory=list)
    admissions: list[PlannedAdmission] = dataclasses.field(
        default_factory=list)
    chunks: list[PrefillChunk] = dataclasses.field(default_factory=list)
    rejections: list[Request] = dataclasses.field(default_factory=list)
    decode_slots: list[int] = dataclasses.field(default_factory=list)
    # Upper bound on this iteration's decode latency, computed at plan time
    # from the traffic the plan left pending (streamed + promotion debt in,
    # write-back debt out, NVMe pendings, chunk piggyback seconds). The
    # executor's dt can only come in at or under this, modulo bytes that
    # provably arrive after planning (COW copies, chunk host-spill
    # write-backs, pages a same-plan one-shot prefill spilled to host) —
    # the trace auditor enforces exactly that bound. None when the plan
    # has no decode slots.
    certified_dt_s: float | None = None
    # The PCIe byte totals certified_dt_s was derived from. The executor
    # charges any excess of its actual traffic over these as uncertified
    # slack, so the auditor can hold dt to certified + excess/link_bw.
    certified_kv_in_bytes: float = 0.0
    certified_kv_out_bytes: float = 0.0


@dataclasses.dataclass
class IterationOutcome:
    """The executor's report after applying a plan."""
    dt_s: float                    # modeled iteration latency (0 if idle)
    finished_rids: list[int] = dataclasses.field(default_factory=list)
    tokens_emitted: int = 0
    chunks_run: int = 0
    preemptions: int = 0
    resumes: int = 0


class Scheduler:
    """Queue + slot-assignment policy over a ``TieredKVAllocator``.

    Constructed with the executor's accounting handles and SLO models:
    ``rec_decode.lookup`` (performance record §4.4), ``times_fn`` (analytic
    layer times), ``ttft_model`` (modeled prefill latency incl. spill
    write-back), and ``max_interval_fn`` (memory-bounded interval ceiling
    under current KV usage). All are plain callables so policy unit tests
    can stub them without building an engine.
    """

    def __init__(self, kv: TieredKVAllocator, swap: SwapScheduler,
                 max_batch: int, max_seq: int,
                 rec_decode, times_fn: Callable,
                 ttft_model: Callable[[Request, float], float],
                 max_interval_fn: Callable[[], int],
                 scfg: SchedulerConfig = SchedulerConfig(),
                 prefill_seconds: Callable[[int], float] | None = None):
        self.kv = kv
        self.swap = swap
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.rec_decode = rec_decode
        self.times_fn = times_fn
        self.ttft_model = ttft_model
        self.max_interval_fn = max_interval_fn
        # the executor's chunk cost model (engine._prefill_seconds) is
        # injected so the seconds the scheduler certifies in TPOT checks
        # are exactly the seconds the executor charges to the clock; the
        # fallback (standalone/unit-test construction) applies the same
        # no-offload stack-time formula
        self.prefill_seconds = prefill_seconds or (
            lambda tokens: self.times_fn(1, tokens, "prefill")
            .t_iter_no_offload_s if tokens > 0 else 0.0)
        self.cfg = scfg
        if scfg.prefill_chunk_tokens > 0:
            page = kv.pcfg.page_size
            self.chunk_tokens = -(-scfg.prefill_chunk_tokens // page) * page
        else:
            self.chunk_tokens = 0
        self.queue: list[Request] = []
        self.preempted: list[Request] = []
        self._prefilling: list[Request] = []   # chunked prefills in flight
        self.stats = {"iterations": 0, "tokens": 0, "preemptions": 0,
                      "resumes": 0, "chunked_prefill_iters": 0,
                      "disk_demotions": 0, "disk_stagings": 0,
                      "migrations_out": 0, "migrations_in": 0}
        self._iv = NO_OFFLOAD                  # interval of the current plan
        self.last_dt_s = 0.0                   # last nonzero observed dt
        # disaggregated prefill role: parked requests are held for peer
        # handoff instead of resuming locally (the fleet exports them at
        # the next boundary; clearing the flag restores the ordinary
        # priority-resume path as a graceful fallback)
        self.hold_resumes = False

    # ------------------------------------------------------------- queue I/O --
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue or self.preempted or self._prefilling)

    # ------------------------------------------------- cross-instance moves --
    def take_preempted(self, rid: int) -> Request | None:
        """Remove a parked request from this scheduler's preempted set (the
        fleet is exporting it to a peer instance). Returns the request, or
        None if ``rid`` is not parked here."""
        for req in self.preempted:
            if req.rid == rid:
                self.preempted.remove(req)
                self.stats["migrations_out"] += 1
                return req
        return None

    def adopt_parked(self, req: Request) -> None:
        """Adopt a request migrated in from a peer instance. It joins the
        preempted set — parked, host-resident — and resumes through the
        ordinary ``_plan_resumes`` priority path, token-exactly, from the
        ``next_token``/``resume_pos`` snapshot it carried over."""
        self.preempted.append(req)
        self.stats["migrations_in"] += 1

    def withdraw(self, rid: int) -> Request | None:
        """Remove a still-QUEUED request (never admitted — no KV claimed,
        nothing to roll back) so the fleet router can re-bind its route to
        a peer at an iteration boundary. Returns the request, or None if
        ``rid`` is not waiting in this scheduler's queue."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                return req
        return None

    def certify_handoff(self, n_pages: int, tpot_slo_s: float,
                        active: list[ActiveInfo]) -> bool:
        """Would adopting a live post-prefill handoff of ``n_pages`` keep
        every TPOT budget on THIS (decode) side? The import's bytes ride
        the peer link and drain into the next iteration's ``peer_s`` term
        — certified here exactly the way NVMe staging is certified in
        ``_resume_feasible``: host room first (free + prefix-cache reclaim
        + disk-demotable capacity), then the modeled iteration time with
        the prospective peer-in pages folded in, against the tightest TPOT
        among the active set and the arriving request. The fleet offers a
        handoff ticket only after this returns True — a refusal leaves the
        request parked on the prefill side (nothing moves)."""
        room = (self.kv.host.free_pages + self.kv.reclaimable_host_pages()
                + self._demotable_to_disk([a.rid for a in active]))
        if n_pages > room:
            return False
        if not active:
            # starvation guard, as in _resume_feasible: an idle decode
            # instance always absorbs the handoff — the transfer is its
            # only work
            return True
        kv_in_now = (self.swap.streamed_bytes([a.rid for a in active])
                     + self.swap.pending_in_bytes())
        dt = self._iter_dt(len(active), kv_in_now,
                           self.swap.pending_out_bytes(),
                           self._chunk_overhead_s(),
                           extra_peer_in_pages=n_pages)
        bound = min([a.tpot_slo_s for a in active] + [tpot_slo_s])
        return dt <= bound * (1 + 1e-9)

    # -------------------------------------------------------------- planning --
    def plan(self, view: SchedulerView) -> IterationPlan:
        self._iv = view.interval if view.interval else NO_OFFLOAD
        plan = IterationPlan(target_interval=view.interval)
        free_slots = sorted(view.free_slots)
        active = list(view.active)

        self._plan_resumes(plan, active, free_slots)
        self._plan_admissions(plan, active, free_slots)
        self._plan_chunks(plan)

        # non-chunked admissions were appended to `active` as they were
        # planned (they decode this same iteration, like the fused engine)
        plan.decode_slots = sorted(a.slot for a in active)
        if active:
            # certify the decode latency this plan implies: promotions +
            # residual streaming together are exactly one pass over the
            # active requests' host pages however the swap scheduler splits
            # it, so streamed-now + pending promotion debt upper-bounds the
            # executor's kv_in (post-plan frees only shrink it)
            rids = [a.rid for a in active]
            plan.certified_kv_in_bytes = (self.swap.streamed_bytes(rids)
                                          + self.swap.pending_in_bytes())
            plan.certified_kv_out_bytes = self.swap.pending_out_bytes()
            plan.certified_dt_s = self._iter_dt(
                len(active), plan.certified_kv_in_bytes,
                plan.certified_kv_out_bytes, self._chunk_overhead_s())
        return plan

    def note_outcome(self, outcome: IterationOutcome) -> None:
        self.stats["iterations"] += 1
        self.stats["tokens"] += outcome.tokens_emitted
        self.stats["preemptions"] += outcome.preemptions
        self.stats["resumes"] += outcome.resumes
        self.stats["chunked_prefill_iters"] += int(outcome.chunks_run > 0)
        if outcome.dt_s > 0:
            self.last_dt_s = outcome.dt_s

    # ------------------------------------------------------------- disk tier --
    def _iter_dt(self, n_active: int, kv_in: float, kv_out: float,
                 chunk_s: float = 0.0, extra_disk_in_pages: int = 0,
                 extra_disk_out_pages: int = 0,
                 extra_peer_in_pages: int = 0,
                 extra_peer_out_pages: int = 0) -> float:
        """Modeled next-iteration latency under the given PCIe KV traffic
        PLUS the disk link's own term — NVMe bytes already pending at the
        allocator and any prospective staging/demotion pages the caller is
        about to cause — PLUS the peer link's term for handoff traffic
        (pending imports/exports and any prospective handoff the caller is
        certifying). Disk and peer traffic never ride the PCIe budget, but
        a feasibility check that ignored either would certify TPOTs that
        channel's queue then breaks."""
        link = self.kv.disk_link
        plink = self.kv.peer_link
        pb = self.kv.page_bytes
        times = self.times_fn(n_active, self.max_seq, "decode")
        return iter_time_with_interval_kv(
            times, self._iv, kv_in, kv_out,
            disk_in_bytes=self.swap.pending_disk_in_bytes()
            + extra_disk_in_pages * pb,
            disk_out_bytes=self.swap.pending_disk_out_bytes()
            + extra_disk_out_pages * pb,
            disk_bw=link.bw_bytes_s,
            disk_latency_s=link.latency_s,
            peer_in_bytes=self.swap.pending_peer_in_bytes()
            + extra_peer_in_pages * pb,
            peer_out_bytes=self.swap.pending_peer_out_bytes()
            + extra_peer_out_pages * pb,
            peer_bw=plink.bw_bytes_s,
            peer_latency_s=plink.latency_s) + chunk_s

    def _demotable_to_disk(self, active_rids: list[int],
                           exclude_rid: int | None = None,
                           include_rids=(), pinned=()) -> int:
        """Host frames the disk tier could absorb right now: unique HOST
        frames of parked requests (oldest park first) — plus those of
        ``include_rids`` (a victim about to be parked: once it parks, its
        spilled pages are cold too) — that no active sibling references
        and that are not ``pinned`` (a dedup preview's hit frames:
        ``_free_host_via_disk`` will refuse to move them, so counting
        them would certify capacity that cannot be freed), capped by
        free + reclaimable disk capacity. Zero without a disk tier."""
        if self.kv.disk.total_pages == 0:
            return 0
        hot = self.kv.hot_pages(active_rids, HOST) | set(pinned)
        frames: set[int] = set()
        rids = [r.rid for r in self.preempted if r.rid != exclude_rid]
        rids += [r for r in include_rids if r not in rids]
        for rid in rids:
            frames.update(p for p in self.kv.host_pages_of(rid)
                          if p not in hot)
            frames.update(res.page
                          for res in self.kv.reserves_of(rid).values()
                          if res.tier == HOST and res.page not in hot)
        room = self.kv.disk.free_pages + self.kv.reclaimable_disk_pages()
        return min(len(frames), room)

    def _free_host_via_disk(self, n_pages: int, active_rids: list[int],
                            exclude_rid: int | None = None,
                            also_rids=(), keep=(),
                            keep_disk: set[int] | None = None,
                            youngest_first: bool = False) -> int:
        """Make host room by demoting parked preempted requests' host
        pages to the disk tier — the policy that replaces "refuse the park
        / evict the cache" under host pressure. Park/admission pressure
        takes the LONGEST-parked first (oldest pays the NVMe round trip:
        it resumes last anyway); a resume staging takes the YOUNGEST first
        (oldest work wins the host tier — demoting the next-to-resume
        would bounce its pages straight back). ``also_rids`` go last (a
        victim whose park is being arranged: its spilled pages were hot a
        moment ago); ``keep``/``keep_disk`` protect a caller's
        dedup-preview frames from moving under the allocation they
        certify. Returns the pages actually freed; NVMe write-back bytes
        are accumulated at the allocator and charged to the disk term of
        the next iteration."""
        freed = 0
        parked = [r.rid for r in self.preempted if r.rid != exclude_rid]
        if youngest_first:
            parked.reverse()
        rids = parked + [r for r in also_rids if r not in parked]
        for rid in rids:
            if freed >= n_pages:
                break
            moves = self.kv.demote_to_disk(rid, n_pages - freed,
                                           active_rids, keep=keep,
                                           keep_disk=keep_disk)
            freed += len(moves)
            self.stats["disk_demotions"] += len(moves)
        return freed

    # --------------------------------------------------------------- resumes --
    def _plan_resumes(self, plan: IterationPlan, active: list[ActiveInfo],
                      free_slots: list[int]) -> None:
        """Parked requests re-enter with priority over new admissions (they
        are the oldest work in the system), as soon as a slot is free and
        the worst case of their return traffic — every still-host page
        streamed or promoted next iteration, plus the NVMe staging of any
        disk-demoted pages — fits every TPOT budget. A disk-parked request
        whose staging cannot fit the host tier first pushes YOUNGER parked
        requests' pages down to disk (oldest work wins the host tier)."""
        if self.hold_resumes:
            # prefill-role instance: its parked set is the handoff staging
            # area, not resume candidates — decode belongs to a peer
            return
        for req in list(self.preempted):
            if not free_slots:
                return
            if not self._resume_feasible(req, active):
                continue
            n_disk = self.kv.parked_disk_pages(req.rid)
            short = self.kv.resume_staging_shortfall(req.rid)
            if short > 0:
                # youngest parked first: oldest work wins the host tier
                self._free_host_via_disk(short, [a.rid for a in active],
                                         exclude_rid=req.rid,
                                         youngest_first=True)
            moves = self.kv.resume(req.rid)
            if moves is None:
                continue                     # host cannot stage: stay parked
            if n_disk:
                self.stats["disk_stagings"] += n_disk
            # only HOST-sourced promotions ride the PCIe link; direct
            # disk->device stagings charge the NVMe term alone (their
            # host-transit bytes were never moved, so never billed)
            self.swap.note_promotions(
                sum(1 for m in moves if m.src_tier == HOST))
            slot = free_slots.pop(0)
            self.preempted.remove(req)
            plan.resumes.append(PlannedResume(req, slot, moves))
            active.append(ActiveInfo(req, slot))

    def _resume_feasible(self, req: Request, active: list[ActiveInfo]
                         ) -> bool:
        if not active:
            # starvation guard: with nothing else decoding, the resumed
            # request is the system's only work — resume unconditionally
            # rather than stall forever on its own one-time return spike
            return True
        n_disk = self.kv.parked_disk_pages(req.rid)
        shortfall = self.kv.resume_staging_shortfall(req.rid)
        if shortfall > self._demotable_to_disk([a.rid for a in active],
                                               exclude_rid=req.rid):
            return False                     # NVMe staging cannot land
        host_pages = set(self.kv.host_pages_of(req.rid))
        streamed = self.swap.streamed_host_pages([a.rid for a in active])
        # next iteration's kv_in is promotion copies + remaining streaming —
        # together exactly one pass over the union, however the swap
        # scheduler splits it; later iterations are strictly cheaper. Disk
        # pages stage to host first, so they join the same worst-case pass
        # AND charge the NVMe term — reads for the staging itself plus the
        # write-backs of the shortfall demotions it will trigger.
        kv_in = ((len(streamed | host_pages) + n_disk)
                 * self.kv.page_bytes + self.swap.pending_in_bytes())
        dt = self._iter_dt(len(active) + 1, kv_in,
                           self.swap.pending_out_bytes(),
                           self._chunk_overhead_s(),
                           extra_disk_in_pages=n_disk,
                           extra_disk_out_pages=shortfall)
        bound = min([a.tpot_slo_s for a in active] + [req.tpot_slo_s])
        return dt <= bound * (1 + 1e-9)

    # ------------------------------------------------------------ admissions --
    def _plan_admissions(self, plan: IterationPlan,
                         active: list[ActiveInfo],
                         free_slots: list[int]) -> None:
        for req in list(self.queue):
            if not free_slots:
                return
            total = req.prompt_len + req.max_new_tokens
            if total > self.max_seq:
                req.state = State.REJECTED
                req.reject_reason = "exceeds max_seq"
                self.queue.remove(req)
                plan.rejections.append(req)
                continue
            # SLO feasibility (paper §4.2: pass back to upper scheduler)
            min_i = self.rec_decode.lookup(req.tpot_slo_s,
                                           len(active) + 1, total)
            max_i = self.max_interval_fn()
            if min_i > max_i:
                req.state = State.REJECTED
                req.reject_reason = (f"SLO infeasible: min interval {min_i} "
                                     f"> max {max_i}")
                self.queue.remove(req)
                plan.rejections.append(req)
                continue
            chunked = (self.chunk_tokens > 0
                       and req.prompt_len > 0)
            chunked_bound = None
            if chunked:
                # TTFT feasibility must model the CHUNK SCHEDULE, not a
                # one-shot prefill: the prompt rides ceil(plen/chunk)
                # consecutive iterations and TTFT accrues their latencies.
                # A structurally infeasible request (even an idle system
                # cannot meet its SLO) is rejected outright, like the
                # interval check above; a request whose bound only breaks
                # under today's transient traffic waits instead.
                if (self._chunked_ttft_floor(req)
                        > req.ttft_slo_s * (1 + 1e-9)):
                    req.state = State.REJECTED
                    req.reject_reason = ("chunked TTFT floor exceeds SLO: "
                                         f"{req.prompt_len} tokens / "
                                         f"{self.chunk_tokens}-token chunks")
                    self.queue.remove(req)
                    plan.rejections.append(req)
                    continue
                chunked_bound = self._chunked_ttft_bound(req, active)
                if chunked_bound > req.ttft_slo_s * (1 + 1e-9):
                    continue          # transient traffic: retry next iter
            if not self._try_admit_mem(req, total, active):
                if not (self.cfg.preemption
                        and self._try_preempt_for(req, total, active,
                                                  free_slots, plan)):
                    # memory-infeasible NOW: skip, do not head-of-line block
                    # — a later (shorter) request may still fit this
                    # iteration; this one retries next iteration
                    continue
            slot = free_slots.pop(0)
            self.queue.remove(req)
            adm = PlannedAdmission(req, slot, chunked=chunked)
            if not chunked:
                # stamp the TTFT this admission was certified under — the
                # same ttft_model call, over the spill write-back the alloc
                # just claimed, that the executor charges at prefill time
                adm.certified_ttft_s = self.ttft_model(
                    req, self.kv.spill_writeback_bytes_of(req.rid))
            else:
                # the per-chunk piggyback schedule this admission was
                # certified under (the executor accrues real chunk dts
                # into ttft_accum_s against this bound)
                adm.certified_ttft_s = chunked_bound
            plan.admissions.append(adm)
            if chunked:
                self._prefilling.append(req)
                req.slot = slot       # chunks planned below need the slot
            elif req.max_new_tokens > 1:
                # a one-token budget is satisfied by the prefill itself:
                # the slot never activates, so it must not plan as decoding
                active.append(ActiveInfo(req, slot))

    def _try_admit_mem(self, req: Request, total: int,
                       active: list[ActiveInfo]) -> bool:
        """Claim the KV for ``req`` if memory + SLO budgets allow: device
        pool first, host spill (§4.2 extended) second. Either way the
        iteration the request joins already carries KV traffic (siblings'
        streamed pages, queued write-backs, resume promotion copies) — the
        fused engine only TPOT-checked that traffic on the spill path, so a
        tight-TPOT request could be admitted on device into an iteration
        another request's streaming had already pushed past its SLO."""
        kv_in_now = (self.swap.streamed_bytes([a.rid for a in active])
                     + self.swap.pending_in_bytes())
        kv_out_now = self.swap.pending_out_bytes()
        chunk_s = self._chunk_overhead_s(req)
        disk_now = (self.swap.pending_disk_in_bytes()
                    + self.swap.pending_disk_out_bytes())
        if kv_in_now or kv_out_now or chunk_s or disk_now:
            dt = self._iter_dt(len(active) + 1, kv_in_now, kv_out_now,
                               chunk_s)
            slos = [a.tpot_slo_s for a in active] + [req.tpot_slo_s]
            if dt > min(slos) * (1 + 1e-9):
                return False               # current KV traffic breaks TPOT
        if self.kv.alloc(req.rid, total, allow_host=False,
                         prompt=req.prompt) is not None:
            return True
        return self._try_spill_admit(req, total, active)

    def _try_spill_admit(self, req: Request, total: int,
                         active: list[ActiveInfo]) -> bool:
        """§4.2 admission, extended for the host KV tier: the device pool is
        full, but the request can be admitted with its cold prefix on host —
        provided the streamed KV traffic keeps every active request's TPOT
        and the new request's TTFT feasible at the current interval. The
        stream rides the same link as weight prefetch, so feasibility is
        evaluated with the combined-traffic iteration time.

        Prefix-dedup savings are accounted here: pages the prompt shares
        with live frames claim no new capacity, shared host pages already
        streamed for an active sibling add no link traffic, and dedup'd
        pages need no spill write-back during prefill."""
        kv = self.kv
        active_rids = [a.rid for a in active]
        pv = kv.dedup_preview(req.prompt, total)
        n_fresh = (kv.device.pages_for(total) - pv.n_hits
                   + int(pv.need_reserve))
        n_host = max(n_fresh - kv.device.free_pages, 0)
        n_revive = len(pv.disk_hit_pages())
        host_room = (kv.host.free_pages + kv.reclaimable_host_pages()
                     + self._demotable_to_disk(
                         active_rids, pinned=pv.host_hit_pages()))
        if n_host + n_revive > host_room:
            return False                       # no host room: wait
        if n_host <= 0 and not pv.host_hit_pages() and not n_revive:
            # cannot happen in the synchronous engine: alloc(allow_host=
            # False) fails exactly when fresh pages overflow to host or a
            # hit is host-resident, and nothing mutates between that call
            # and this recomputation. Kept as a defensive wait (not an
            # assert) so an accounting bug degrades to queueing, never to
            # an unchecked host admission.
            return False
        pb = kv.page_bytes
        # unique host frames after admission: currently streamed ∪ shared
        # host hits, plus the freshly spilled pages and revived disk hits
        streamed_pages = self.swap.streamed_host_pages(active_rids)
        streamed_after = (len(streamed_pages | pv.host_hit_pages())
                          + n_host + n_revive) * pb \
            + self.swap.pending_in_bytes()
        # prospective NVMe traffic: demotions that make the host room plus
        # the disk-hit revival reads — charged to the disk term up front
        shortfall = max(n_host + n_revive - kv.host.free_pages
                        - kv.reclaimable_host_pages(), 0)
        dt = self._iter_dt(len(active) + 1, streamed_after,
                           self.swap.pending_out_bytes(),
                           self._chunk_overhead_s(req),
                           extra_disk_in_pages=n_revive,
                           extra_disk_out_pages=shortfall)
        slos = [a.tpot_slo_s for a in active]
        tpot_bound = min(slos + [req.tpot_slo_s])
        if dt > tpot_bound * (1 + 1e-9):
            return False                       # streaming would break TPOT
        if self.ttft_model(req, n_host * pb) > req.ttft_slo_s * (1 + 1e-9):
            return False                       # spill write-back breaks TTFT
        if shortfall > 0:
            # host pressure: push long-parked requests' pages down to NVMe
            # instead of letting the admission wait. The preview's hit
            # frames are pinned — demoting or evicting one would leave the
            # alloc below holding dangling references
            self._free_host_via_disk(shortfall, active_rids,
                                     keep=pv.host_hit_pages(),
                                     keep_disk=pv.disk_hit_pages())
        refs = kv.alloc(req.rid, total, allow_host=True,
                        prompt=req.prompt, preview=pv)
        if refs is None:
            return False                       # room-making fell short: wait
        return True

    # ------------------------------------------------------------ preemption --
    def _victim_pool(self, active: list[ActiveInfo]) -> list[ActiveInfo]:
        """Only requests that are genuinely decoding are parkable: a request
        admitted or resumed earlier in this same plan has no decode cursor
        (or just paid its return trip) — parking it would snapshot garbage
        (or thrash)."""
        return [a for a in active if a.req.state == State.DECODING]

    def _select_victim(self, active: list[ActiveInfo]) -> ActiveInfo | None:
        """Victim policy: largest recurring streaming burden first (parking
        it relieves the link every subsequent iteration), then most
        remaining decode work (least sunk progress is stalled), then most
        TPOT headroom (deadline-aware: the request whose budget the last
        observed iteration dented least absorbs the park stall safest),
        then the latest-arrived (highest rid) — FIFO-respecting."""
        cands = self._victim_pool(active)
        if not cands:
            return None
        return max(cands, key=lambda a: (len(self.kv.host_pages_of(a.rid)),
                                         a.remaining,
                                         a.tpot_slo_s - self.last_dt_s,
                                         a.rid))

    def _preempt_could_help(self, req: Request, total: int,
                            active: list[ActiveInfo]) -> bool:
        """Best case (every active parked): would the admission fit? Parking
        cannot fix a TTFT-infeasible spill, so check that bound too before
        disturbing anyone."""
        kv = self.kv
        pv = kv.dedup_preview(req.prompt, total)
        n_fresh = (kv.device.pages_for(total) - pv.n_hits
                   + int(pv.need_reserve))
        freeable = 0
        pool = self._victim_pool(active)
        rids = [a.rid for a in pool]
        for a in pool:
            n_free, _ = kv.park_preview(a.rid,
                                        [r for r in rids if r != a.rid])
            freeable += n_free
        if n_fresh > kv.device.free_pages + freeable:
            return False
        return self.ttft_model(req, 0.0) <= req.ttft_slo_s * (1 + 1e-9)

    def _try_preempt_for(self, req: Request, total: int,
                         active: list[ActiveInfo], free_slots: list[int],
                         plan: IterationPlan) -> bool:
        """Park AT MOST ONE victim — the top-ranked one — and only when
        that single park provably unblocks ``req``; an admission that would
        need several victims' frames waits instead (conservative by
        design: multi-victim sprees are where park/resume churn lives).

        Anti-thrash guards: a victim is only parked when (a) its recurring
        host-streaming burden strictly exceeds the spill shortfall the
        incoming request would add — equal-burden requests never park each
        other, and pure capacity-motivated eviction is a wait, not a park
        (FIFO admission order already gave the running victim its claim) —
        and (b) a dry-run certifies that the admission clears its memory,
        TPOT and TTFT checks once the victim is gone. No partial parking
        sprees: if one park cannot unblock the request, nobody is parked
        and the request waits."""
        if not self._preempt_could_help(req, total, active):
            return False
        victim = self._select_victim(active)
        if victim is None:
            return False
        shortfall = max(self.kv.device.pages_for(total)
                        - self.kv.device.free_pages, 0)
        relief = len(self.kv.host_pages_of(victim.rid))
        if relief <= shortfall:
            return False                       # no strict win: wait instead
        if not self._admission_feasible_after_park(req, total, active,
                                                   victim):
            return False                       # the park would not unblock
        others = [a.rid for a in active if a.rid != victim.rid]
        # host pressure: the park (and the admission's spill behind it)
        # may need more host frames than free + prefix-cache reclaim can
        # supply — demote long-parked requests' pages to the disk tier
        # instead of refusing the park (the dry-run above already counted
        # this capacity and charged the NVMe write-back to the TPOT check)
        raw_need, _ = self.kv.park_preview(victim.rid, others)
        pv = self.kv.dedup_preview(req.prompt, total)
        n_spill = max(self.kv.device.pages_for(total) - pv.n_hits
                      + int(pv.need_reserve)
                      - (self.kv.device.free_pages + raw_need), 0)
        over = (raw_need + n_spill + len(pv.disk_hit_pages())
                - self.kv.host.free_pages
                - self.kv.reclaimable_host_pages())
        if over > 0:
            # oldest parked requests first; the victim's own spilled pages
            # (cold the moment it parks) retire last. The preview's hit
            # frames are pinned for the _try_admit_mem re-allocation below
            self._free_host_via_disk(over, others, also_rids=[victim.rid],
                                     keep=pv.host_hit_pages(),
                                     keep_disk=pv.disk_hit_pages())
        moves = self.kv.park(victim.rid, others)
        if moves is None:
            # the park fell through after room-making (e.g. disk reclaim
            # came up short of the dry-run's estimate). If the victim's own
            # spill was already retired, stage it straight back: an ACTIVE
            # request must never be left holding disk-tier pages.
            undone = self.kv.unspill_from_disk(victim.rid)
            self.stats["disk_stagings"] += undone
            return False                       # host cannot absorb the park
        self.swap.note_demotions(len(moves))
        active.remove(victim)
        free_slots.append(victim.slot)
        free_slots.sort()
        self.preempted.append(victim.req)
        plan.preemptions.append(
            PlannedPreemption(victim.req, victim.slot, moves))
        return self._try_admit_mem(req, total, active)

    def _admission_feasible_after_park(self, req: Request, total: int,
                                       active: list[ActiveInfo],
                                       victim: ActiveInfo) -> bool:
        """Dry-run of the post-park admission, no mutation: device frames
        the park would free are credited, the victim's streaming debits
        vanish, and the park's own write-back joins the pending kv_out.
        Host supply counts free frames, reclaimable prefix-cache frames
        (``park_preview``'s netted need pins the preview/park parity the
        raw count used to break) AND the disk tier's absorbable capacity —
        whose prospective NVMe write-back is charged to the disk term.
        Mirrors the checks ``_try_admit_mem`` / ``_try_spill_admit`` will
        apply for real after the park."""
        kv = self.kv
        rest = [a for a in active if a.rid != victim.rid]
        rest_rids = [a.rid for a in rest]
        freed, need_host = kv.park_preview(victim.rid, rest_rids)
        pv = kv.dedup_preview(req.prompt, total)
        disk_room = self._demotable_to_disk(rest_rids,
                                            include_rids=[victim.rid],
                                            pinned=pv.host_hit_pages())
        if need_host > kv.host.free_pages + disk_room:
            return False                       # the park itself cannot land
        supply = (kv.host.free_pages + kv.reclaimable_host_pages()
                  + disk_room)
        n_fresh = (kv.device.pages_for(total) - pv.n_hits
                   + int(pv.need_reserve))
        n_host = max(n_fresh - (kv.device.free_pages + freed), 0)
        n_revive = len(pv.disk_hit_pages())
        if n_host + n_revive > supply - freed:
            return False                       # no room for the spill
        pb = kv.page_bytes
        streamed = self.swap.streamed_host_pages(rest_rids)
        kv_in = ((len(streamed | pv.host_hit_pages()) + n_host + n_revive)
                 * pb + self.swap.pending_in_bytes())
        kv_out = self.swap.pending_out_bytes() + freed * pb
        # prospective NVMe traffic if the park + spill overflow into disk
        disk_out = max(freed + n_host + n_revive - kv.host.free_pages
                       - kv.reclaimable_host_pages(), 0)
        dt = self._iter_dt(len(rest) + 1, kv_in, kv_out,
                           self._chunk_overhead_s(req),
                           extra_disk_in_pages=n_revive,
                           extra_disk_out_pages=disk_out)
        slos = [a.tpot_slo_s for a in rest] + [req.tpot_slo_s]
        if dt > min(slos) * (1 + 1e-9):
            return False
        return (self.ttft_model(req, n_host * pb)
                <= req.ttft_slo_s * (1 + 1e-9))

    # --------------------------------------------------------------- chunks --
    def _chunk_overhead_s(self, extra_req: Request | None = None) -> float:
        """Modeled stack seconds the next iteration's prefill chunks add to
        the decode latency every active request pays (the same incremental
        T(end) - T(start) model the executor charges in ``_run_chunks``),
        plus ``extra_req``'s own first chunk when the candidate admission
        would itself be chunked. Folded into every TPOT feasibility check
        so chunk piggybacking cannot break an admission-certified SLO."""
        if self.chunk_tokens <= 0:
            return 0.0

        t_of = self.prefill_seconds
        t = 0.0
        for r in self._prefilling:
            if r.prefill_pos >= r.prompt_len:
                continue
            end = min(r.prefill_pos + self.chunk_tokens, r.prompt_len)
            t += max(t_of(end) - t_of(r.prefill_pos), 0.0)
        if extra_req is not None:
            t += t_of(min(self.chunk_tokens, extra_req.prompt_len))
        return t

    def _chunked_ttft_floor(self, req: Request) -> float:
        """Structural lower bound on a chunked prefill's TTFT: its chunks
        ride ``ceil(prompt_len / chunk_tokens)`` consecutive iterations, so
        even an otherwise idle system pays at least the baseline decode
        latency plus the chunk's own stack time per chunk. No schedule can
        beat this — a request whose floor exceeds its TTFT SLO is rejected
        outright (paper §4.2: pass back to the upper scheduler)."""
        base = iter_time_with_interval_kv(
            self.times_fn(1, self.max_seq, "decode"), self._iv)
        t_of = self.prefill_seconds
        total, start = 0.0, 0
        while start < req.prompt_len:
            end = min(start + self.chunk_tokens, req.prompt_len)
            total += base + max(t_of(end) - t_of(start), 0.0)
            start = end
        return total

    def _chunked_ttft_bound(self, req: Request,
                            active: list[ActiveInfo]) -> float:
        """Certified TTFT for a chunked admission: the modeled latencies of
        the iterations its chunks ride (TTFT accrues per chunk, exactly as
        the executor charges it). The first chunk's iteration carries the
        KV/NVMe traffic already pending at plan time plus every in-flight
        prefill's chunk overhead; later chunks ride iterations with that
        transient traffic drained — the same "later iterations are strictly
        cheaper" worst-case shape ``_resume_feasible`` certifies under."""
        t_of = self.prefill_seconds
        n = len(active) + 1
        kv_in_now = (self.swap.streamed_bytes([a.rid for a in active])
                     + self.swap.pending_in_bytes())
        base = iter_time_with_interval_kv(
            self.times_fn(n, self.max_seq, "decode"), self._iv)
        total = self._iter_dt(n, kv_in_now, self.swap.pending_out_bytes(),
                              self._chunk_overhead_s(req))
        start = min(self.chunk_tokens, req.prompt_len)
        while start < req.prompt_len:
            end = min(start + self.chunk_tokens, req.prompt_len)
            total += base + max(t_of(end) - t_of(start), 0.0)
            start = end
        return total

    def _plan_chunks(self, plan: IterationPlan) -> None:
        """One page-aligned chunk per in-flight chunked prefill per
        iteration, piggybacked on the decode step."""
        for req in list(self._prefilling):
            if req.state in (State.FINISHED, State.REJECTED) \
                    or req.prefill_pos >= req.prompt_len:
                self._prefilling.remove(req)
                continue
            start = req.prefill_pos
            end = min(start + self.chunk_tokens, req.prompt_len)
            plan.chunks.append(PrefillChunk(req, req.slot, start, end))
