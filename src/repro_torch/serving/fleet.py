"""Multi-instance serving fleet: KV-affinity routing + cross-instance
preemption.

A ``Fleet`` owns N independent ``ServingEngine`` instances — each with its
own allocator, data plane, tuner and trace — and a ``Router`` that places
every arriving request ONCE, at its arrival instant, on the instance whose
state scores best:

  * **claimed prefix hits** — the router hashes the prompt ONE time with the
    same page-chained rolling hash the prefix index uses
    (``prefix_page_keys``) and probes every instance's index with that one
    key list (``TieredKVAllocator.claimed_prefix_hits``). An instance that
    already holds the prompt's leading pages serves them by refcount bump
    instead of fresh prefill + spill traffic — the whole point of affinity.
  * **queue depth / predicted queueing delay** — waiting + parked requests
    over the instance's current packing capacity
    (``engine._batch_capacity``), scaled by its modeled iteration time; an
    instance whose predicted delay already breaks the request's TTFT SLO is
    only chosen when no instance is clean.
  * **link pressure** — the fleet-wide link-budget owner's per-instance
    share of the host link (``FleetLinkBudget.pressure``): affinity never
    steers more traffic onto an instance already saturating the bus the
    coordinator arbitrates.

The fleet's step loop is event-driven on the modeled clocks: the engine
whose clock lags steps next, and arrivals interleave at their exact
instants (each instance keeps the arrival-honoring ``idle_wait_s``
discipline of ``ServingEngine.run``, so every per-instance trace still
tiles and audits). With a shared ``link_bw``, every step runs the §4.5
arbitration across the WHOLE fleet — the bus coordinator promoted to
fleet-wide link-budget owner.

Cross-instance preemption: when an instance is overloaded (requests parked
AND more waiting) while a peer has strictly less load and host room, the
oldest parked request's KV serializes into a ``MigrationTicket`` (host
frames in token order + the ``next_token``/``resume_pos`` cursor snapshot),
transfers over a modeled peer ``LinkSpec``, and resumes bitwise-exactly on
the peer through its ordinary resume path. The transfer's modeled seconds
and payload bytes are charged to BOTH instances' iteration clocks/records
and conserved by the trace auditor (invariant I11) — plus the fleet-level
cross-check here (``Fleet.audit``): total bytes exported == total bytes
imported across the fleet.

Disaggregated prefill/decode: engines constructed with ``role="prefill"``
or ``role="decode"`` split the fleet. The router binds prompts to prefill
instances only; a prefill instance parks every freshly-prefilled request
(TTFT charged on its side, ``hold_resumes`` keeps local decode away), and
after every fleet step ``_maybe_handoff`` drains the staging set peer-ward:
the least-loaded decode instance whose scheduler CERTIFIES the transfer
(host room + the peer-extended feasibility term against the live
population's tightest TPOT) adopts the ticket through the PEER tier. The
payload's bytes ride the peer link's own concurrent channel (``peer_s`` in
both endpoints' next iteration records — invariant I12), so the transfer
overlaps the exporter's next prefill instead of stalling it; a refused
import rolls back into the frames the export just freed. Routes re-bind
per iteration boundary (``_rescore_queued``): a request still waiting in
one queue moves to a peer that now strictly wins, e.g. one that drained
since the arrival instant. Because shape-bucketed prefill makes KV pages
placement-independent, greedy tokens are bitwise identical across the
disaggregated fleet, the symmetric affinity fleet, and one pooled
instance — the differential suite pins exactly that.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.coordinator import FleetLinkBudget
from repro_torch.core.interval import NO_OFFLOAD
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_offload import LinkSpec, prefix_page_keys
from repro_torch.serving.request import Request
from repro_torch.serving.telemetry import summarize_latency

# NVLink/NIC-class peer interconnect for migration tickets: distinct from
# (and faster than) the host PCIe link the coordinator arbitrates
DEFAULT_PEER_LINK = LinkSpec(bw_bytes_s=16e9, latency_s=1e-5)

ROUTER_POLICIES = ("affinity", "round_robin")


@dataclasses.dataclass
class RouteDecision:
    """Why one arrival landed where it did (kept for tests/debugging)."""
    rid: int
    instance: int
    hits: list[int]                # claimed prefix hits per instance
    delays: list[float]            # predicted queueing delay per instance
    loads: list[float]             # occupancy + link-pressure per instance


class Router:
    """Stateless-per-request placement policy over the fleet's engines.

    ``affinity`` scores every instance by (prefix hits, occupancy + link
    pressure, predicted delay) and admits to the argmax — SLO-clean
    instances strictly beat dirty ones, more claimed prefix pages beat
    fewer, then the least loaded wins. ``round_robin`` is the baseline the
    differential compares byte traffic against."""

    def __init__(self, policy: str = "affinity",
                 budget: FleetLinkBudget | None = None):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(have {ROUTER_POLICIES})")
        self.policy = policy
        self.budget = budget
        self._rr = 0
        self.decisions: list[RouteDecision] = []

    def scores(self, req: Request, engines: list[ServingEngine]
               ) -> tuple[list[int], list[float], list[float], list[tuple]]:
        """Per-instance (hits, delays, loads, score tuples) for one request
        — the comparable quantities both the arrival-time route and the
        per-boundary re-score rank by."""
        # hash the prompt ONCE; probe every instance's index with the same
        # key list (all instances of a fleet share one dedup scope — same
        # model config and page geometry)
        keys = prefix_page_keys(engines[0].kv.scope, req.prompt,
                                engines[0].kv.pcfg.page_size)
        hits, delays, loads, scores = [], [], [], []
        for eng in engines:
            iv = eng.interval if eng.interval else NO_OFFLOAD
            h = eng.kv.claimed_prefix_hits(keys)
            depth = len(eng.queue) + len(eng.scheduler.preempted)
            cap = max(eng._batch_capacity(iv), 1)
            # every waiting request needs ~one iteration slot-batch ahead
            # of this one; parked requests resume with priority, so they
            # queue ahead too
            delay_s = depth / cap * eng.instance_state().t_iter_s
            load = ((depth + eng._active_batch())
                    / max(eng.ecfg.max_batch, 1))
            if self.budget is not None:
                load += self.budget.pressure(eng.instance_state(), iv)
            ok = delay_s <= req.ttft_slo_s * (1 + 1e-9)
            hits.append(h)
            delays.append(delay_s)
            loads.append(load)
            scores.append((ok, h, -load, -delay_s))
        return hits, delays, loads, scores

    def route(self, req: Request, engines: list[ServingEngine]) -> int:
        if self.policy == "round_robin":
            i = self._rr % len(engines)
            self._rr += 1
            return i
        hits, delays, loads, scores = self.scores(req, engines)
        best = max(range(len(engines)), key=lambda i: scores[i])
        self.decisions.append(RouteDecision(req.rid, best, hits, delays,
                                            loads))
        return best


class Fleet:
    """N independent engines + a router + (optionally) the fleet-wide link
    budget and the cross-instance preemption policy."""

    def __init__(self, engines: list[ServingEngine],
                 policy: str = "affinity",
                 link_bw: float | None = None,
                 peer_link: LinkSpec = DEFAULT_PEER_LINK,
                 migrate: bool = True,
                 rescore: bool = True):
        assert engines, "a fleet needs at least one instance"
        self.engines = engines
        self.budget = FleetLinkBudget(link_bw) if link_bw else None
        self.router = Router(policy, self.budget)
        self.peer_link = peer_link
        self.migrate = migrate
        self.rescore = rescore
        self.migrations: list[dict] = []
        # role-typed instances: any non-"mixed" role makes the fleet
        # disaggregated — prompts route to prefill instances, finished
        # prefills hand off peer-ward, decode instances own the TPOT side
        self.prefill_engines = [e for e in engines if e.role == "prefill"]
        self.decode_engines = [e for e in engines if e.role == "decode"]
        self.disagg = bool(self.prefill_engines or self.decode_engines)
        if self.disagg and not (self.prefill_engines
                                and self.decode_engines):
            raise ValueError("a disaggregated fleet needs at least one "
                             "prefill and one decode instance")
        # per-link handoff ledger: one entry per accepted ticket, keyed by
        # (src, dst) in audit — the cross-instance half of invariant I12
        self.handoffs: list[dict] = []
        self.reroutes: list[dict] = []

    # ------------------------------------------------------------- serving --
    def _routable(self) -> list[ServingEngine]:
        """Engines fresh prompts may route to: prefill instances in a
        disaggregated fleet (decode instances only receive handoffs),
        everyone otherwise."""
        return self.prefill_engines if self.disagg else self.engines

    def _place(self, req: Request, eng: ServingEngine) -> None:
        if eng.clock_s < req.arrival_s:
            # the chosen instance drained before this arrival: jump its
            # clock exactly like the single-engine arrival-honoring loop
            dt = req.arrival_s - eng.clock_s
            eng.idle_wait_s += dt
            eng.idle_wait_total_s += dt
            eng.clock_s = req.arrival_s
        eng.scheduler.submit(req)

    def _submit(self, req: Request) -> None:
        routable = self._routable()
        eng = routable[self.router.route(req, routable)]
        self._place(req, eng)
        req.submitted_s = max(req.arrival_s, 0.0)

    def _rescore_queued(self) -> None:
        """Routes bind per-boundary, not per-arrival: a request still
        WAITING in one instance's queue (no KV claimed — withdrawing it
        rolls back nothing) re-scores against the routable set after every
        fleet step and moves when another instance now strictly wins, e.g.
        a peer that drained since the arrival instant."""
        if not self.rescore or self.router.policy != "affinity":
            return
        routable = self._routable()
        if len(routable) < 2:
            return
        for eng in routable:
            for req in list(eng.queue):
                cur = routable.index(eng)
                _, _, _, scores = self.router.scores(req, routable)
                best = max(range(len(routable)), key=lambda i: scores[i])
                if best == cur or not scores[best] > scores[cur]:
                    continue
                got = eng.scheduler.withdraw(req.rid)
                if got is None:
                    continue
                self._place(got, routable[best])
                self.reroutes.append({
                    "rid": req.rid, "src": eng.name,
                    "dst": routable[best].name})

    def _step(self, eng: ServingEngine) -> None:
        if self.budget is not None:
            eng.step(peers=[e for e in self.engines if e is not eng],
                     link_bw=self.budget.link_bw)
        else:
            eng.step()

    def _busy(self, eng: ServingEngine) -> bool:
        """Does stepping this engine make progress? For a prefill-role
        instance the parked set is the handoff staging area, not local
        work: with ``hold_resumes`` set, a step that only holds parked
        requests is a no-op whose clock never advances, so counting it as
        busy would spin the min-clock event loop forever."""
        if eng.role == "prefill" and eng.scheduler.hold_resumes:
            return bool(eng.queue) or eng._active_batch() > 0 \
                or bool(eng.scheduler._prefilling)
        return eng.scheduler.has_work() or eng._active_batch() > 0

    def run(self, requests: list[Request], max_iters: int = 100_000,
            submit_all: bool = False) -> dict:
        """Serve ``requests`` across the fleet on the modeled clocks.

        Event-driven: the next event is whichever comes first of (a) the
        next arrival (routed and submitted at its exact instant) and (b)
        the lagging busy engine's next iteration. ``submit_all=True``
        routes everything up front (burst-compat path)."""
        pending = sorted(requests, key=lambda r: r.arrival_s)
        n_pend = 0
        if submit_all:
            for req in pending:
                self._submit(req)
            n_pend = len(pending)
        iters = 0
        while iters < max_iters:
            busy = [e for e in self.engines if self._busy(e)]
            t_step = min((e.clock_s for e in busy), default=math.inf)
            t_arr = (pending[n_pend].arrival_s if n_pend < len(pending)
                     else math.inf)
            if t_arr <= t_step:
                if t_arr == math.inf:
                    # drained of arrivals and no busy engine — but a
                    # prefill instance may still hold parked handoffs the
                    # decode side refused earlier; push them through now
                    # (empty decode populations certify via the
                    # starvation guard) before declaring the fleet done
                    if self.disagg and self._flush_handoffs():
                        continue
                    break
                req = pending[n_pend]
                n_pend += 1
                self._submit(req)
                continue
            eng = min(busy, key=lambda e: (e.clock_s,
                                           self.engines.index(e)))
            self._step(eng)
            iters += 1
            if self.disagg:
                # handoffs are the only cross-instance movement in a
                # disaggregated fleet: the emergency migration path would
                # raid the prefill staging set with a synchronous,
                # uncertified transfer
                self._maybe_handoff()
            elif self.migrate and len(self.engines) > 1:
                self._maybe_migrate(eng)
            self._rescore_queued()
        for eng in self.engines:
            if eng.data_plane is not None:
                eng.data_plane.sync()
        return self.summary()

    # ----------------------------------------------------------- migration --
    def _load(self, eng: ServingEngine) -> int:
        return (len(eng.queue) + len(eng.scheduler.preempted)
                + eng._active_batch())

    def _maybe_migrate(self, src: ServingEngine) -> None:
        """Cross-instance preemption policy, evaluated after ``src`` steps:
        when src is overloaded (a parked request is being starved by
        waiting admissions) and a peer has strictly less load plus the host
        room to adopt, the OLDEST parked request migrates there. Capacity
        is checked before anything moves, so a failed import can only come
        from reclaim falling short — rolled back into the frames the export
        just freed."""
        if not (src.scheduler.preempted and src.queue):
            return
        cand = src.scheduler.preempted[0]
        pages = src.kv.export_parked(cand.rid)    # read-only exportability
        if pages is None:
            return
        peers = [e for e in self.engines if e is not src
                 and e.host_pool is not None]
        if not peers:
            return
        dst = min(peers, key=self._load)
        if self._load(dst) + 1 >= self._load(src):
            return                         # no strict win: don't thrash
        if (dst.kv.host.free_pages + dst.kv.reclaimable_host_pages()
                < len(pages)):
            return                         # peer cannot host the ticket
        out = src.export_parked_request(cand.rid)
        assert out is not None             # exportability checked above
        req, ticket = out
        if not dst.import_parked_request(req, ticket):
            # reclaim fell short of the precheck: re-import into the frames
            # the export just freed (guaranteed room), books stay conserved
            assert src.import_parked_request(req, ticket), \
                "rollback import into just-freed frames failed"
            return
        # the transfer rides the modeled peer link and charges BOTH
        # instances' clocks — src serializes out, dst lands it; the pending
        # seconds stamp each side's next iteration record (audited: I4/I11)
        t = self.peer_link.latency_s
        if self.peer_link.bw_bytes_s > 0:
            t += ticket.bytes_total / self.peer_link.bw_bytes_s
        for eng in (src, dst):
            eng.clock_s += t
            eng.mig_wait_s += t
            eng.mig_wait_total_s += t
        self.migrations.append({
            "rid": req.rid, "src": src.name, "dst": dst.name,
            "n_pages": ticket.n_pages, "bytes": ticket.bytes_total,
            "transfer_s": t})

    # ------------------------------------------------------------- handoff --
    def _pick_decode(self, req: Request,
                     n_pages: int) -> ServingEngine | None:
        """Least-loaded decode instance whose scheduler certifies the
        handoff (host room + peer-extended feasibility against the live
        population's tightest TPOT), or None — certify-before-offer, so a
        refusal costs nothing."""
        cands = [e for e in self.decode_engines if e.host_pool is not None]
        for dst in sorted(cands, key=self._load):
            if dst.scheduler.certify_handoff(n_pages, req.tpot_slo_s,
                                             dst._view().active):
                return dst
        return None

    def _maybe_handoff(self) -> int:
        """Live post-prefill KV handoff, evaluated after every fleet step:
        each prefill instance's parked set (its handoff staging area —
        ``hold_resumes`` keeps local resume away from it) drains peer-ward
        to whichever certified decode instance is least loaded. The
        payload's bytes ride the PEER tier's own link term (``peer_s`` in
        both endpoints' next iteration records — the transfer overlaps the
        exporter's next prefill), so unlike the emergency migration path
        nothing stalls synchronously. A refused import (certification can
        shift between the precheck and the claim) rolls back into the
        frames the export just freed."""
        moved = 0
        for src in self.prefill_engines:
            for req in list(src.scheduler.preempted):
                pages = src.kv.export_parked(req.rid)   # read-only probe
                if pages is None:
                    continue                  # not (yet) host-exportable
                dst = self._pick_decode(req, len(pages))
                if dst is None:
                    continue
                out = src.export_handoff(req.rid)
                if out is None:
                    continue
                got, ticket = out
                if dst.clock_s < src.clock_s:
                    # causality: the decode side cannot resume KV that has
                    # not been exported yet — an idle importer waits for
                    # the export instant (same discipline as arrivals)
                    dt = src.clock_s - dst.clock_s
                    dst.idle_wait_s += dt
                    dst.idle_wait_total_s += dt
                    dst.clock_s = src.clock_s
                if not dst.import_handoff(got, ticket):
                    src.rollback_handoff(got, ticket)
                    continue
                moved += 1
                self.handoffs.append({
                    "rid": got.rid, "src": src.name, "dst": dst.name,
                    "n_pages": ticket.n_pages,
                    "bytes": ticket.bytes_total})
        return moved

    def _flush_handoffs(self) -> bool:
        """Drained-fleet backstop: no arrivals left and no busy engine,
        but prefill instances still hold parked requests. First retry the
        ordinary handoff path (an empty decode population certifies via
        the starvation guard whenever host room exists); if nothing can
        move — the decode tier genuinely cannot absorb the stranded set —
        degrade gracefully by releasing ``hold_resumes`` so the stranded
        prefill instance decodes locally (the resume path is
        placement-independent, so tokens stay bitwise)."""
        if self._maybe_handoff() > 0:
            return True
        changed = False
        for eng in self.prefill_engines:
            if eng.scheduler.preempted and eng.scheduler.hold_resumes:
                eng.scheduler.hold_resumes = False
                changed = True
        return changed

    # --------------------------------------------------------------- audit --
    def audit(self) -> tuple[bool, list[str]]:
        """Per-instance trace audits (I1-I11) plus the fleet-level
        migration conservation cross-check: every byte one instance
        exported, exactly one instance imported."""
        violations: list[str] = []
        for eng in self.engines:
            rep = eng.trace.audit()
            violations += [f"{eng.name}: {v}" for v in rep.violations]
        out_b = sum(e.mig_out_bytes_total for e in self.engines)
        in_b = sum(e.mig_in_bytes_total for e in self.engines)
        if out_b != in_b:
            violations.append(f"fleet: migrated-out bytes {out_b:.0f} != "
                              f"migrated-in bytes {in_b:.0f}")
        n_out = sum(e.n_migrated_out for e in self.engines)
        n_in = sum(e.n_migrated_in for e in self.engines)
        if n_out != n_in:
            violations.append(f"fleet: {n_out} tickets exported != "
                              f"{n_in} adopted")
        tik = sum(m["bytes"] for m in self.migrations)
        if tik != out_b:
            violations.append(f"fleet: ticket log {tik:.0f}B != exported "
                              f"{out_b:.0f}B")
        # handoff conservation — the cross-instance half of invariant I12:
        # bytes exported == bytes imported, fleet-wide and per link
        ho_out = sum(e.handoff_out_bytes_total for e in self.engines)
        ho_in = sum(e.handoff_in_bytes_total for e in self.engines)
        if ho_out != ho_in:
            violations.append(f"fleet: handoff-out bytes {ho_out:.0f} != "
                              f"handoff-in bytes {ho_in:.0f}")
        n_ho_out = sum(e.n_handoff_out for e in self.engines)
        n_ho_in = sum(e.n_handoff_in for e in self.engines)
        if n_ho_out != n_ho_in:
            violations.append(f"fleet: {n_ho_out} handoff tickets exported "
                              f"!= {n_ho_in} adopted")
        # per-endpoint: the ledger's per-instance byte totals must match
        # each endpoint's own counters (no link moved bytes the ledger
        # didn't see, and vice versa)
        led_out: dict[str, float] = {}
        led_in: dict[str, float] = {}
        for h in self.handoffs:
            led_out[h["src"]] = led_out.get(h["src"], 0.0) + h["bytes"]
            led_in[h["dst"]] = led_in.get(h["dst"], 0.0) + h["bytes"]
        for eng in self.engines:
            if led_out.get(eng.name, 0.0) != eng.handoff_out_bytes_total:
                violations.append(
                    f"fleet: ledger says {eng.name} exported "
                    f"{led_out.get(eng.name, 0.0):.0f}B but it booked "
                    f"{eng.handoff_out_bytes_total:.0f}B")
            if led_in.get(eng.name, 0.0) != eng.handoff_in_bytes_total:
                violations.append(
                    f"fleet: ledger says {eng.name} imported "
                    f"{led_in.get(eng.name, 0.0):.0f}B but it booked "
                    f"{eng.handoff_in_bytes_total:.0f}B")
        return not violations, violations

    # ------------------------------------------------------------- summary --
    def summary(self) -> dict:
        finished = [r for e in self.engines for r in e.finished]
        done = [r.metrics() for r in finished]
        total_tokens = sum(m["tokens"] for m in done)
        wall = max(e.clock_s for e in self.engines)
        link = {}
        for eng in self.engines:
            for k, v in eng.trace.totals().items():
                link[k] = link.get(k, 0.0) + v
        return {
            "instances": len(self.engines),
            "router": self.router.policy,
            "finished": len(finished),
            "rejected": sum(len(e.rejected) for e in self.engines),
            "tokens": total_tokens,
            "wall_modeled_s": wall,
            "throughput_tok_s": total_tokens / wall if wall > 0 else 0.0,
            "slo_ok": all(m["ttft_ok"] and m["tpot_ok"] for m in done),
            "disagg": self.disagg,
            "migrations": len(self.migrations),
            "migrated_bytes": sum(m["bytes"] for m in self.migrations),
            "handoffs": len(self.handoffs),
            "handoff_bytes": sum(h["bytes"] for h in self.handoffs),
            "reroutes": len(self.reroutes),
            "preemptions": sum(e.scheduler.stats["preemptions"]
                               for e in self.engines),
            "resumes": sum(e.scheduler.stats["resumes"]
                           for e in self.engines),
            "queue_delay": summarize_latency([m["queue_delay_s"]
                                              for m in done]),
            "ttft": summarize_latency([m["ttft_s"] for m in done]),
            "tpot": summarize_latency([t for r in finished
                                       for t in r.tpot_s]),
            "link_bytes": link,
            "per_instance": {
                e.name: {
                    "role": e.role,
                    "finished": len(e.finished),
                    "rejected": len(e.rejected),
                    "clock_s": e.clock_s,
                    "preemptions": e.scheduler.stats["preemptions"],
                    "migrations_out": e.n_migrated_out,
                    "migrations_in": e.n_migrated_in,
                    "handoffs_out": e.n_handoff_out,
                    "handoffs_in": e.n_handoff_in,
                    "link_bytes": e.trace.totals(),
                } for e in self.engines},
            "per_request": done,
        }
