"""Iteration-level telemetry plane for the serving engine.

Select-N's premise is that per-iteration timing is deterministic enough to
certify SLOs — so the run itself should be checkable against the model that
certified it. This module gives every ``ServingEngine`` an always-on
``TraceRecorder`` (``engine.trace``) the executor populates on each
``step()``:

  * one typed ``IterationRecord`` per iteration — interval, decode batch,
    admissions/parks/resumes/rejections, per-link bytes moved (PCIe in/out,
    NVMe in/out) split into their sources (streamed / promoted / pending
    drains / COW copies), the modeled dt decomposed into compute vs
    link-queue vs disk-queue terms (``iter_time_breakdown_kv``), per-tier
    allocator occupancy snapshots, and per-slot TPOT-headroom gauges;
  * ``RequestEvent``s for admit / reject / park / resume / prefill / chunk /
    finish, stamped on the modeled clock, carrying the scheduler's certified
    TTFT/dt where one was issued.

On top of the records sit two consumers:

  * ``TraceRecorder.to_perfetto`` — a Chrome trace-event JSON exporter
    (load the file at https://ui.perfetto.dev): per-slot decode/prefill
    spans on the modeled clock, PCIe / NVMe copy-stream lanes, a parked
    lane, and per-tier occupancy counters, making the modeled overlap
    visible.
  * ``audit_trace`` — a conservation-checking auditor that replays a
    finished trace and machine-checks the invariants documented on
    ``AuditReport``. The differential suites assert a clean audit on their
    lockstep traces; ``launch/serve.py --trace-out`` exits nonzero on any
    violation.

All byte quantities are integer page multiples far below 2**53, so the
byte-conservation checks are EXACT equalities — a single page charged twice
or dropped anywhere in the engine trips the auditor.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import numpy as np

TRACE_SCHEMA = "repro-trace/v1"

# matches the scheduler's feasibility slack (_FEAS_RTOL): certified bounds
# are compared with the same tolerance admission used
_RTOL = 1e-9
_ATOL = 1e-12


def summarize_latency(samples) -> dict:
    """Shared latency summary (p50/p99 via ``np.quantile``): one definition
    for ``engine.run``, the fig benchmarks and the differential suites
    instead of five hand-rolled copies. ``None`` entries are dropped."""
    xs = np.asarray([s for s in samples if s is not None], dtype=float)
    if xs.size == 0:
        return {"n": 0, "mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0,
                "max_s": 0.0}
    return {"n": int(xs.size),
            "mean_s": float(xs.mean()),
            "p50_s": float(np.quantile(xs, 0.5)),
            "p99_s": float(np.quantile(xs, 0.99)),
            "max_s": float(xs.max())}


# --------------------------------------------------------------- records --
@dataclasses.dataclass
class SlotGauge:
    """Per-request SLO headroom at the end of one decode iteration: how much
    of the TPOT budget the iteration left unspent (negative = violation)."""
    rid: int
    slot: int
    tpot_slo_s: float
    headroom_s: float              # tpot_slo_s - observed dt


@dataclasses.dataclass
class RequestEvent:
    """One request-lifecycle event on the modeled clock. ``detail`` carries
    kind-specific payload (certified_ttft_s, ttft_s, reject reason, chunk
    bounds, ...)."""
    kind: str                      # admit|reject|park|resume|prefill|chunk|finish
    rid: int
    t_s: float
    slot: int = -1
    dur_s: float = 0.0             # prefill/chunk span length
    iteration: int = -1            # index of the step that emitted it
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IterationRecord:
    """Everything one ``step()`` charged to the modeled clock, decomposed so
    the auditor can re-derive the totals from the parts."""
    index: int
    t_start_s: float
    t_end_s: float
    dt_s: float                    # what note_outcome reported (0 if idle)
    interval: int
    decode_batch: int
    n_chunks: int = 0
    admitted: list[int] = dataclasses.field(default_factory=list)
    rejected: list[int] = dataclasses.field(default_factory=list)
    parked: list[int] = dataclasses.field(default_factory=list)
    resumed: list[int] = dataclasses.field(default_factory=list)
    finished: list[int] = dataclasses.field(default_factory=list)
    # PCIe bytes charged to this iteration, and their sources; the auditor
    # checks kv_in == streamed + promoted + pending_in + cow_in exactly
    kv_in_bytes: float = 0.0
    kv_out_bytes: float = 0.0
    streamed_bytes: float = 0.0
    promoted_bytes: float = 0.0
    pending_in_bytes: float = 0.0   # resume-promotion debt drained this step
    pending_out_bytes: float = 0.0  # demotion write-back debt drained
    cow_in_bytes: float = 0.0
    cow_out_bytes: float = 0.0
    # bytes the scheduler could NOT have certified at plan time (post-plan
    # COW stream growth, chunk host-spill write-backs, same-plan prefill
    # spill that streams into its own decode): the certified-dt check
    # allows exactly these bytes' serialization on top of the bound
    uncertified_in_bytes: float = 0.0
    uncertified_out_bytes: float = 0.0
    # PCIe totals the scheduler derived certified_dt_s from; uncertified_*
    # must equal max(actual - certified, 0) exactly (audited)
    certified_kv_in_bytes: float = 0.0
    certified_kv_out_bytes: float = 0.0
    # NVMe channel
    disk_in_bytes: float = 0.0
    disk_out_bytes: float = 0.0
    disk_in_pages: int = 0
    disk_out_pages: int = 0
    # PEER channel: live KV handoff traffic over the instance-to-instance
    # link, drained into this iteration exactly like the NVMe pendings
    peer_in_bytes: float = 0.0
    peer_out_bytes: float = 0.0
    peer_in_pages: int = 0
    peer_out_pages: int = 0
    # physical copy-stage engine activity sampled at the end of the step:
    # pages handed to the data plane vs. pages whose copies actually ran.
    # In sync mode the two are equal every iteration; in async mode issued
    # can lead completed by the in-flight window (audited by I10)
    staged_issued_pages: int = 0
    staged_completed_pages: int = 0
    # modeled dt decomposition (iter_time_breakdown_kv)
    compute_s: float = 0.0
    kv_in_s: float = 0.0
    kv_out_s: float = 0.0
    stall_s: float = 0.0
    pcie_s: float = 0.0
    disk_s: float = 0.0
    peer_s: float = 0.0
    chunk_s: float = 0.0
    # max(pcie_s, disk_s, peer_s); dt = model + chunk
    model_dt_s: float = 0.0
    # drained-engine wait run() skipped to the next arrival BEFORE this
    # iteration began (arrival-honoring loop): the clock-tiling check
    # expects t_start == previous t_end + idle_wait_s (+ mig_wait_s)
    idle_wait_s: float = 0.0
    # cross-instance migration (fleet): ticket payload bytes this instance
    # sent/received over the peer link since the previous iteration, and
    # the modeled transfer seconds charged to this instance's clock before
    # this iteration began. Both endpoints charge the same transfer — the
    # bytes ride BOTH iteration clocks (audited by I11)
    mig_in_bytes: float = 0.0
    mig_out_bytes: float = 0.0
    mig_wait_s: float = 0.0
    link_bw_bytes_s: float = 0.0
    certified_dt_s: float | None = None   # scheduler's stamp (decode only)
    occupancy: dict = dataclasses.field(default_factory=dict)
    reserve_pages: int = 0
    gauges: list[SlotGauge] = dataclasses.field(default_factory=list)


# -------------------------------------------------------------- recorder --
class TraceRecorder:
    """Accumulates the typed trace; attached always-on as ``engine.trace``
    (records are a few hundred bytes per iteration — the differential suites
    audit every run without opting in)."""

    def __init__(self, name: str, max_batch: int, page_bytes: int):
        self.name = name
        self.max_batch = max_batch
        self.page_bytes = page_bytes
        self.iterations: list[IterationRecord] = []
        self.events: list[RequestEvent] = []
        # the engine wires a counters snapshot (allocator/swap totals at
        # export time) so whole-trace conservation can be cross-checked
        # against state the recorder never touched
        self._footer_fn: Callable[[], dict] | None = None

    # -- population -------------------------------------------------------
    def event(self, kind: str, rid: int, t_s: float, slot: int = -1,
              dur_s: float = 0.0, **detail: Any) -> None:
        self.events.append(RequestEvent(kind=kind, rid=rid, t_s=t_s,
                                        slot=slot, dur_s=dur_s,
                                        iteration=len(self.iterations),
                                        detail=detail))

    def add_iteration(self, rec: IterationRecord) -> None:
        self.iterations.append(rec)

    # -- export -----------------------------------------------------------
    def footer(self) -> dict:
        return dict(self._footer_fn()) if self._footer_fn is not None else {}

    def to_dict(self) -> dict:
        return {"schema": TRACE_SCHEMA,
                "engine": self.name,
                "max_batch": self.max_batch,
                "page_bytes": self.page_bytes,
                "iterations": [dataclasses.asdict(r) for r in self.iterations],
                "events": [dataclasses.asdict(e) for e in self.events],
                "footer": self.footer()}

    def totals(self) -> dict:
        """Whole-trace per-link byte totals (what the summary prints)."""
        it = self.iterations
        return {"pcie_in_bytes": sum(r.kv_in_bytes for r in it),
                "pcie_out_bytes": sum(r.kv_out_bytes for r in it),
                "disk_in_bytes": sum(r.disk_in_bytes for r in it),
                "disk_out_bytes": sum(r.disk_out_bytes for r in it),
                "streamed_bytes": sum(r.streamed_bytes for r in it),
                "promoted_bytes": sum(r.promoted_bytes for r in it),
                "mig_in_bytes": sum(r.mig_in_bytes for r in it),
                "mig_out_bytes": sum(r.mig_out_bytes for r in it),
                "peer_in_bytes": sum(r.peer_in_bytes for r in it),
                "peer_out_bytes": sum(r.peer_out_bytes for r in it)}

    def audit(self) -> "AuditReport":
        return audit_trace(self.to_dict())

    def write_trace(self, path: str, audit: "AuditReport | None" = None
                    ) -> None:
        """Write the structured trace (plus an audit report) as JSON."""
        out = self.to_dict()
        if audit is not None:
            out["audit"] = {"ok": audit.ok, "checks": audit.checks,
                            "violations": audit.violations}
        with open(path, "w") as f:
            json.dump(out, f, indent=1)

    # -- Perfetto ---------------------------------------------------------
    # lane layout: tids [0, max_batch) are decode slots; the copy streams
    # and scheduler get their own "threads"
    _PCIE_TID = 100
    _NVME_TID = 101
    _SCHED_TID = 102
    _PARKED_TID = 103
    _PEER_TID = 104

    def to_perfetto(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable). Timestamps are the
        MODELED clock in microseconds — spans show what the analytic
        schedule charged, not wall time."""
        us = 1e6
        pid = 1
        ev: list[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": f"engine:{self.name} (modeled clock)"}}]
        names = {t: n for t, n in
                 [(self._PCIE_TID, "pcie copy stream"),
                  (self._NVME_TID, "nvme channel"),
                  (self._SCHED_TID, "scheduler"),
                  (self._PARKED_TID, "parked"),
                  (self._PEER_TID, "peer link")]}
        names.update({s: f"slot {s}" for s in range(self.max_batch)})
        for tid, nm in sorted(names.items()):
            ev.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": nm}})

        def slice_(tid, name, t0, dur, **args):
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": t0 * us, "dur": max(dur, 0.0) * us,
                       "args": args})

        def instant(tid, name, t0, **args):
            ev.append({"ph": "i", "pid": pid, "tid": tid, "name": name,
                       "ts": t0 * us, "s": "t", "args": args})

        for r in self.iterations:
            t0 = r.t_end_s - r.dt_s          # decode window of this step
            for g in r.gauges:
                slice_(g.slot, f"decode r{g.rid}", t0, r.dt_s,
                       headroom_us=g.headroom_s * us,
                       tpot_slo_us=g.tpot_slo_s * us, iteration=r.index)
            if r.kv_in_s > 0:
                slice_(self._PCIE_TID, f"kv_in {int(r.kv_in_bytes)}B",
                       t0, r.kv_in_s, iteration=r.index)
            if r.kv_out_s > 0:
                slice_(self._PCIE_TID, f"kv_out {int(r.kv_out_bytes)}B",
                       t0 + r.kv_in_s, r.kv_out_s, iteration=r.index)
            if r.disk_s > 0:
                slice_(self._NVME_TID,
                       f"nvme {r.disk_in_pages}p in / {r.disk_out_pages}p "
                       f"out", t0, r.disk_s, iteration=r.index)
            if r.peer_s > 0:
                slice_(self._PEER_TID,
                       f"peer {r.peer_in_pages}p in / {r.peer_out_pages}p "
                       f"out", t0, r.peer_s, iteration=r.index)
            for tier, occ in r.occupancy.items():
                ev.append({"ph": "C", "pid": pid, "tid": 0,
                           "name": f"{tier}_pages", "ts": r.t_end_s * us,
                           "args": {"used": occ.get("used_pages", 0),
                                    "cache": occ.get("cache_pages", 0)}})

        parked_since: dict[int, float] = {}
        for e in self.events:
            if e.kind in ("prefill", "chunk"):
                slice_(e.slot if e.slot >= 0 else self._SCHED_TID,
                       f"{e.kind} r{e.rid}", e.t_s, e.dur_s, **e.detail)
            elif e.kind == "park":
                instant(self._SCHED_TID, f"park r{e.rid}", e.t_s)
                parked_since[e.rid] = e.t_s
            elif e.kind == "resume":
                t0 = parked_since.pop(e.rid, None)
                if t0 is not None:
                    slice_(self._PARKED_TID, f"parked r{e.rid}", t0,
                           e.t_s - t0)
                instant(self._SCHED_TID, f"resume r{e.rid}", e.t_s)
            elif e.kind == "finish":
                instant(e.slot if e.slot >= 0 else self._SCHED_TID,
                        f"finish r{e.rid}", e.t_s)
            else:                          # admit / reject
                instant(self._SCHED_TID, f"{e.kind} r{e.rid}", e.t_s,
                        **e.detail)
        t_end = (self.iterations[-1].t_end_s if self.iterations else 0.0)
        for rid, t0 in parked_since.items():   # still parked at export
            slice_(self._PARKED_TID, f"parked r{rid}", t0, t_end - t0)
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)


# --------------------------------------------------------------- auditor --
@dataclasses.dataclass
class AuditReport:
    """Result of replaying a finished trace against the conservation
    invariants:

      I1  per-iteration PCIe conservation (EXACT): ``kv_in_bytes ==
          streamed + promoted + pending_in + cow_in`` and ``kv_out_bytes ==
          pending_out + cow_out`` — every byte charged to the clock has a
          named source, none is charged twice.
      I2  NVMe bytes are whole pages: ``disk_*_bytes == disk_*_pages *
          page_bytes`` (exact).
      I3  dt identity: ``dt == max(pcie_s, disk_s) + chunk_s`` exactly, and
          the PCIe term decomposes into compute + kv_in + stall.
      I4  clock continuity: ``t_end == t_start + one-shot prefill TTFTs +
          dt`` per iteration, and iterations tile the clock
          (``t_start[i+1] == t_end[i] + idle_wait_s[i+1]``, where
          ``idle_wait_s`` is the drained-engine jump the arrival-honoring
          loop took to the next arrival — never backwards).
      I5  occupancy: per tier, ``0 <= used_pages <= total_pages`` and cache
          frames never exceed used frames.
      I6  certified dt: every decode iteration's observed dt is bounded by
          the dt the scheduler certified at plan time, plus the
          serialization of bytes that provably arrived after planning
          (COW copies, chunk host-spill write-backs, same-plan prefill
          spill): ``dt <= certified + uncertified_bytes / link_bw``
          (within admission's 1e-9 slack), where the uncertified totals
          must exactly equal the actual traffic's excess over the
          plan-stamped ``certified_kv_in/out_bytes``.
      I7  certified TTFT: a non-chunked admission's observed prefill TTFT
          never exceeds the TTFT the scheduler certified when admitting it.
      I8  whole-trace conservation vs the allocator's own counters
          (footer): summed per-iteration drains equal the allocator/swap
          cumulative totals minus what is still pending — bytes charged to
          the clock are exactly the bytes the allocator moved, per tier.
      I9  request conservation: every admit is matched by a finish or is
          still in flight at export; parks == resumes + still-parked.
      I10 copy-stage conservation: every page handed to the data plane is
          charged exactly once — summed per-iteration issued pages equal
          the plane's issue counter, the plane's issue counter equals its
          completion counter plus what is still in flight, and at every
          iteration prefix completions never exceed issues (an
          async-reordered trace where a completion is recorded before its
          issue fails here).
      I11 cross-instance migration conservation (fleet traces only): per
          direction, summed per-iteration ticket bytes equal the engine's
          cumulative migration counters minus what is still pending a
          stamp; every per-iteration total is a whole-page multiple;
          summed ``mig_wait_s`` equals the cumulative transfer seconds
          charged to this instance's clock; and migrate_in/out event
          counts match the footer counters. I4 and I9 fold migration in:
          ``t_start == prev t_end + idle_wait + mig_wait``, and a
          migrated-in request counts like an admit (it finishes, stays
          active/parked, or migrates back out) while a migrated-out one
          leaves the books like a finish.
      I12 KV handoff conservation (PEER tier, disaggregated fleets): per
          direction, summed per-iteration peer-link drains equal the
          allocator's cumulative peer page counters minus the pages still
          pending a drain; handoff byte counters are exactly those pages'
          bytes; handoff_in/out event counts (net of rollbacks) match the
          footer. I2, I3 and I9 fold the peer channel in: peer bytes are
          whole pages, ``model_dt_s == max(pcie_s, disk_s, peer_s)``, and
          a handed-off request changes books like a migrated one. The
          cross-instance half — exporter bytes == importer bytes per peer
          link — is ``Fleet.audit``'s check, which sees all endpoints.
    """
    ok: bool
    violations: list[str]
    checks: int
    totals: dict = dataclasses.field(default_factory=dict)


def _close(a: float, b: float, scale: float = 1.0) -> bool:
    return abs(a - b) <= _RTOL * max(abs(a), abs(b), scale) + _ATOL


def audit_trace(trace: dict) -> AuditReport:
    """Replay a finished trace (``TraceRecorder.to_dict()`` or the JSON file
    written by ``--metrics-out``) and check the ``AuditReport`` invariants.
    Pure dict-in / report-out: auditable offline, no engine required."""
    violations: list[str] = []
    checks = 0

    def check(cond: bool, msg: str) -> None:
        nonlocal checks
        checks += 1
        if not cond:
            violations.append(msg)

    pb = float(trace.get("page_bytes", 0))
    its: list[dict] = trace.get("iterations", [])
    events: list[dict] = trace.get("events", [])
    footer: dict = trace.get("footer", {})

    # one-shot prefill TTFTs advance the clock inside the step that ran
    # them (chunked prefills accrue TTFT without their own clock advance)
    prefill_s_of: dict[int, float] = {}
    for e in events:
        if e["kind"] == "prefill":
            prefill_s_of[e["iteration"]] = \
                prefill_s_of.get(e["iteration"], 0.0) + e["dur_s"]

    prev_end = None
    for r in its:
        i = r["index"]
        # I1: per-iteration PCIe conservation (exact: integer page bytes)
        parts_in = (r["streamed_bytes"] + r["promoted_bytes"]
                    + r["pending_in_bytes"] + r["cow_in_bytes"])
        check(r["kv_in_bytes"] == parts_in,
              f"iter {i}: kv_in {r['kv_in_bytes']:.0f}B != streamed "
              f"{r['streamed_bytes']:.0f} + promoted {r['promoted_bytes']:.0f}"
              f" + pending_in {r['pending_in_bytes']:.0f} + cow_in "
              f"{r['cow_in_bytes']:.0f}")
        check(r["kv_out_bytes"] == r["pending_out_bytes"]
              + r["cow_out_bytes"],
              f"iter {i}: kv_out {r['kv_out_bytes']:.0f}B != pending_out "
              f"{r['pending_out_bytes']:.0f} + cow_out "
              f"{r['cow_out_bytes']:.0f}")
        # I2: NVMe / peer-link bytes are whole pages
        check(r["disk_in_bytes"] == r["disk_in_pages"] * pb,
              f"iter {i}: disk_in {r['disk_in_bytes']:.0f}B != "
              f"{r['disk_in_pages']} pages * {pb:.0f}B")
        check(r["disk_out_bytes"] == r["disk_out_pages"] * pb,
              f"iter {i}: disk_out {r['disk_out_bytes']:.0f}B != "
              f"{r['disk_out_pages']} pages * {pb:.0f}B")
        check(r.get("peer_in_bytes", 0.0)
              == r.get("peer_in_pages", 0) * pb,
              f"iter {i}: peer_in {r.get('peer_in_bytes', 0.0):.0f}B != "
              f"{r.get('peer_in_pages', 0)} pages * {pb:.0f}B")
        check(r.get("peer_out_bytes", 0.0)
              == r.get("peer_out_pages", 0) * pb,
              f"iter {i}: peer_out {r.get('peer_out_bytes', 0.0):.0f}B != "
              f"{r.get('peer_out_pages', 0)} pages * {pb:.0f}B")
        # I3: dt identity + decomposition
        check(r["dt_s"] == r["model_dt_s"] + r["chunk_s"],
              f"iter {i}: dt {r['dt_s']} != model {r['model_dt_s']} + chunk "
              f"{r['chunk_s']}")
        check(r["model_dt_s"] == max(r["pcie_s"], r["disk_s"],
                                     r.get("peer_s", 0.0)),
              f"iter {i}: model dt {r['model_dt_s']} != max(pcie "
              f"{r['pcie_s']}, disk {r['disk_s']}, peer "
              f"{r.get('peer_s', 0.0)})")
        if r["decode_batch"] > 0:
            check(_close(r["pcie_s"],
                         r["compute_s"] + r["kv_in_s"] + r["stall_s"],
                         scale=r["pcie_s"]),
                  f"iter {i}: pcie {r['pcie_s']} != compute + kv_in + stall")
            if r["link_bw_bytes_s"] > 0:
                check(_close(r["kv_in_s"],
                             r["kv_in_bytes"] / r["link_bw_bytes_s"],
                             scale=r["kv_in_s"]),
                      f"iter {i}: kv_in_s inconsistent with bytes/bw")
        # I4: clock continuity
        pre = prefill_s_of.get(i, 0.0)
        check(_close(r["t_end_s"], r["t_start_s"] + pre + r["dt_s"],
                     scale=max(r["t_end_s"], 1e-9)),
              f"iter {i}: clock {r['t_start_s']} + prefill {pre} + dt "
              f"{r['dt_s']} != {r['t_end_s']}")
        if prev_end is not None:
            idle = r.get("idle_wait_s", 0.0)
            mig = r.get("mig_wait_s", 0.0)
            check(_close(r["t_start_s"], prev_end + idle + mig,
                         scale=max(r["t_start_s"], 1e-9))
                  and r["t_start_s"] >= prev_end,
                  f"iter {i}: t_start {r['t_start_s']} != previous t_end "
                  f"{prev_end} + idle wait {idle} + migration wait {mig}")
        prev_end = r["t_end_s"]
        # I5: occupancy within capacity
        for tier, occ in r["occupancy"].items():
            used, total = occ["used_pages"], occ["total_pages"]
            check(0 <= used <= total,
                  f"iter {i}: {tier} occupancy {used} exceeds capacity "
                  f"{total}")
            cache = occ.get("cache_pages", 0)
            check(cache <= used,
                  f"iter {i}: {tier} cache frames {cache} > used {used}")
        # I6: observed dt vs the scheduler's certified bound. Post-plan
        # bytes (COW copies, chunk host-spill write-backs, same-plan
        # prefill spill) delay a serial copy stream by at most bytes/bw —
        # allow exactly that. The uncertified totals themselves must be
        # exactly the actual traffic's excess over the certified totals
        # (both integer page multiples).
        cert = r.get("certified_dt_s")
        if cert is not None and r["decode_batch"] > 0:
            check(r["uncertified_in_bytes"]
                  == max(r["kv_in_bytes"] - r["certified_kv_in_bytes"], 0.0),
                  f"iter {i}: uncertified_in {r['uncertified_in_bytes']}B "
                  f"!= kv_in {r['kv_in_bytes']} - certified "
                  f"{r['certified_kv_in_bytes']}")
            check(r["uncertified_out_bytes"]
                  == max(r["kv_out_bytes"] - r["certified_kv_out_bytes"],
                         0.0),
                  f"iter {i}: uncertified_out {r['uncertified_out_bytes']}B "
                  f"!= kv_out {r['kv_out_bytes']} - certified "
                  f"{r['certified_kv_out_bytes']}")
            slack = 0.0
            if r["link_bw_bytes_s"] > 0:
                slack = (r["uncertified_in_bytes"]
                         + r["uncertified_out_bytes"]) / r["link_bw_bytes_s"]
            check(r["dt_s"] <= (cert + slack) * (1 + _RTOL) + _ATOL,
                  f"iter {i}: observed dt {r['dt_s']} exceeds certified "
                  f"{cert} + uncertified slack {slack}")

    # I7: certified TTFT per admission (non-chunked admissions only)
    certified_ttft = {e["rid"]: e["detail"]["certified_ttft_s"]
                      for e in events if e["kind"] == "admit"
                      and e["detail"].get("certified_ttft_s") is not None}
    for e in events:
        if e["kind"] == "prefill" and e["rid"] in certified_ttft:
            cert = certified_ttft[e["rid"]]
            check(e["dur_s"] <= cert * (1 + _RTOL) + _ATOL,
                  f"rid {e['rid']}: observed TTFT {e['dur_s']} exceeds "
                  f"certified {cert}")

    # I8: whole-trace conservation vs allocator counters
    totals = {
        "pcie_in_bytes": sum(r["kv_in_bytes"] for r in its),
        "pcie_out_bytes": sum(r["kv_out_bytes"] for r in its),
        "disk_in_bytes": sum(r["disk_in_bytes"] for r in its),
        "disk_out_bytes": sum(r["disk_out_bytes"] for r in its),
    }
    if footer:
        drained = {
            "disk_in": (footer["disk_in_pages_total"]
                        - footer["pending_disk_in_pages"]) * pb,
            "disk_out": (footer["disk_out_pages_total"]
                         - footer["pending_disk_out_pages"]) * pb,
            "pending_in": (footer["noted_in_pages_total"]
                           - footer["pending_in_pages"]) * pb,
            "pending_out": (footer["noted_out_pages_total"]
                            - footer["pending_out_pages"]) * pb,
            "promoted": footer["promoted_pages_total"] * pb,
        }
        check(totals["disk_in_bytes"] == drained["disk_in"],
              f"trace disk_in {totals['disk_in_bytes']:.0f}B != allocator "
              f"drained {drained['disk_in']:.0f}B")
        check(totals["disk_out_bytes"] == drained["disk_out"],
              f"trace disk_out {totals['disk_out_bytes']:.0f}B != allocator "
              f"drained {drained['disk_out']:.0f}B")
        check(sum(r["pending_in_bytes"] for r in its)
              == drained["pending_in"],
              "trace promotion-debt drains != swap scheduler noted totals")
        check(sum(r["pending_out_bytes"] for r in its)
              == drained["pending_out"],
              "trace write-back drains != swap scheduler noted totals")
        check(sum(r["promoted_bytes"] for r in its) == drained["promoted"],
              "trace promoted bytes != allocator promotion count")
        check(sum(r["cow_in_bytes"] for r in its)
              == footer["cow_in_bytes_total"],
              "trace COW h2d bytes != engine COW counter")
        check(sum(r["cow_out_bytes"] for r in its)
              == footer["cow_out_bytes_total"],
              "trace COW d2h bytes != engine COW counter")

        # I9: request conservation. Migration folds in symmetrically: a
        # migrated-in request counts like an admit (it must finish, stay
        # active/parked, or migrate back out) and joins the parked books
        # without a local park event; a migrated-out one leaves both books.
        n_admit = sum(1 for e in events if e["kind"] == "admit")
        n_finish = sum(1 for e in events if e["kind"] == "finish")
        n_park = sum(1 for e in events if e["kind"] == "park")
        n_resume = sum(1 for e in events if e["kind"] == "resume")
        n_mig_in = sum(1 for e in events if e["kind"] == "migrate_in")
        n_mig_out = sum(1 for e in events if e["kind"] == "migrate_out")
        # live KV handoff folds in exactly like migration; a refused
        # handoff leaves a handoff_out + handoff_rollback pair that nets
        # to zero (the request never left this instance's books)
        n_ho_in = sum(1 for e in events if e["kind"] == "handoff_in")
        n_ho_out = (sum(1 for e in events if e["kind"] == "handoff_out")
                    - sum(1 for e in events
                          if e["kind"] == "handoff_rollback"))
        check(n_finish == footer["n_finished"],
              f"{n_finish} finish events != {footer['n_finished']} finished "
              f"requests")
        check(n_admit + n_mig_in + n_ho_in
              == footer["n_finished"] + footer["n_active"]
              + footer["n_parked"] + n_mig_out + n_ho_out,
              f"{n_admit} admits + {n_mig_in} migrated in + {n_ho_in} "
              f"handed in != finished {footer['n_finished']} + active "
              f"{footer['n_active']} + parked {footer['n_parked']} + "
              f"{n_mig_out} migrated out + {n_ho_out} handed out")
        check(n_park + n_mig_in + n_ho_in
              == n_resume + footer["n_parked"] + n_mig_out + n_ho_out,
              f"{n_park} parks + {n_mig_in} migrated in + {n_ho_in} handed "
              f"in != {n_resume} resumes + {footer['n_parked']} still "
              f"parked + {n_mig_out} migrated out + {n_ho_out} handed out")

        # I11: cross-instance migration conservation (fleet traces only)
        if "mig_out_bytes_total" in footer:
            check(n_mig_in == footer["n_migrated_in"],
                  f"{n_mig_in} migrate_in events != footer "
                  f"{footer['n_migrated_in']}")
            check(n_mig_out == footer["n_migrated_out"],
                  f"{n_mig_out} migrate_out events != footer "
                  f"{footer['n_migrated_out']}")
            for r in its:
                for f_ in ("mig_in_bytes", "mig_out_bytes"):
                    b = r.get(f_, 0.0)
                    whole = b == 0 or (pb > 0 and b == int(b)
                                       and int(b) % int(pb) == 0)
                    check(whole,
                          f"iter {r['index']}: {f_} {b}B not a whole-page "
                          f"multiple of {pb:.0f}B")
            sum_in = sum(r.get("mig_in_bytes", 0.0) for r in its)
            sum_out = sum(r.get("mig_out_bytes", 0.0) for r in its)
            check(sum_in == footer["mig_in_bytes_total"]
                  - footer["pending_mig_in_bytes"],
                  f"trace migration-in bytes {sum_in:.0f}B != engine total "
                  f"{footer['mig_in_bytes_total']:.0f}B - pending "
                  f"{footer['pending_mig_in_bytes']:.0f}B")
            check(sum_out == footer["mig_out_bytes_total"]
                  - footer["pending_mig_out_bytes"],
                  f"trace migration-out bytes {sum_out:.0f}B != engine "
                  f"total {footer['mig_out_bytes_total']:.0f}B - pending "
                  f"{footer['pending_mig_out_bytes']:.0f}B")
            sum_wait = sum(r.get("mig_wait_s", 0.0) for r in its)
            check(_close(sum_wait, footer["mig_wait_total_s"]
                         - footer["pending_mig_wait_s"],
                         scale=max(sum_wait, 1e-9)),
                  f"trace migration wait {sum_wait}s != engine total "
                  f"{footer['mig_wait_total_s']}s - pending "
                  f"{footer['pending_mig_wait_s']}s")

        # I12: KV handoff conservation (PEER tier). Per direction, summed
        # per-iteration peer drains equal the allocator's cumulative peer
        # counters minus what is still pending a drain, and the engine's
        # handoff byte counters are exactly those pages' bytes. The
        # cross-instance half (every exporter's bytes land on exactly one
        # importer, per link) is checked by ``Fleet.audit``, which holds
        # all endpoints' traces.
        if "peer_out_pages_total" in footer:
            check(n_ho_in == footer["n_handoff_in"],
                  f"{n_ho_in} handoff_in events != footer "
                  f"{footer['n_handoff_in']}")
            check(n_ho_out == footer["n_handoff_out"],
                  f"{n_ho_out} net handoff_out events != footer "
                  f"{footer['n_handoff_out']}")
            sum_pin = sum(r.get("peer_in_bytes", 0.0) for r in its)
            sum_pout = sum(r.get("peer_out_bytes", 0.0) for r in its)
            check(sum_pin == (footer["peer_in_pages_total"]
                              - footer["pending_peer_in_pages"]) * pb,
                  f"trace peer-in bytes {sum_pin:.0f}B != allocator drained "
                  f"{(footer['peer_in_pages_total'] - footer['pending_peer_in_pages']) * pb:.0f}B")
            check(sum_pout == (footer["peer_out_pages_total"]
                               - footer["pending_peer_out_pages"]) * pb,
                  f"trace peer-out bytes {sum_pout:.0f}B != allocator "
                  f"drained "
                  f"{(footer['peer_out_pages_total'] - footer['pending_peer_out_pages']) * pb:.0f}B")
            check(footer["handoff_in_bytes_total"]
                  == footer["peer_in_pages_total"] * pb,
                  f"handoff-in bytes {footer['handoff_in_bytes_total']:.0f}B "
                  f"!= {footer['peer_in_pages_total']} peer pages")
            check(footer["handoff_out_bytes_total"]
                  == footer["peer_out_pages_total"] * pb,
                  f"handoff-out bytes "
                  f"{footer['handoff_out_bytes_total']:.0f}B != "
                  f"{footer['peer_out_pages_total']} peer pages")

        # I10: copy-stage conservation (only present once the engine runs a
        # data plane). The final sync() in run() completes trailing pages
        # AFTER the last iteration sampled its counters, so completed sums
        # are bounded by — not equal to — the footer total; issued sums are
        # exact because issues only happen inside steps.
        if "staged_issued_pages_total" in footer:
            sum_issued = sum(r.get("staged_issued_pages", 0) for r in its)
            sum_completed = sum(r.get("staged_completed_pages", 0)
                                for r in its)
            check(sum_issued == footer["staged_issued_pages_total"],
                  f"trace staged issues {sum_issued} != plane issue counter "
                  f"{footer['staged_issued_pages_total']}")
            check(footer["staged_issued_pages_total"]
                  == footer["staged_completed_pages_total"]
                  + footer["staged_inflight_pages"],
                  f"plane issued {footer['staged_issued_pages_total']} != "
                  f"completed {footer['staged_completed_pages_total']} + "
                  f"in flight {footer['staged_inflight_pages']}")
            check(sum_completed <= footer["staged_completed_pages_total"],
                  f"trace staged completions {sum_completed} exceed plane "
                  f"completion counter "
                  f"{footer['staged_completed_pages_total']}")
            run_issued = run_completed = 0
            for r in its:
                run_issued += r.get("staged_issued_pages", 0)
                run_completed += r.get("staged_completed_pages", 0)
                check(run_completed <= run_issued,
                      f"iter {r['index']}: {run_completed} staged pages "
                      f"completed before only {run_issued} were issued "
                      f"(completion recorded ahead of its issue)")
            direct = footer.get("disk_direct_pages_total", 0)
            check(0 <= direct <= footer["disk_in_pages_total"],
                  f"direct disk reads {direct} exceed total disk reads "
                  f"{footer['disk_in_pages_total']}")

    return AuditReport(ok=not violations, violations=violations,
                       checks=checks, totals=totals)
