"""The port's multi-instance fleet (``repro_torch.serving.fleet``) on the
CPU: ``tests/test_fleet.py``'s contracts on port engines at the same
reduced widths (``MAX_SEQ`` 96, page 16), and a lockstep of a port fleet
against the reference's JAX fleet through a forced cross-instance
migration.

The lockstep gives both fleets the same weights (``params_from_numpy``)
and the same trace; the router's decisions, the migrations, each
instance's iteration records, events and counters must come out *equal*
(the policy layer is the same code), and tokens agree under the
``DualEngine`` tie rule (``tests/differential/harness.py``: the port is
teacher-forced with the reference's token on a numeric tie).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core.analyzer import PerformanceAnalyzer  # noqa: E402
from repro_torch.core.hardware import A10  # noqa: E402
from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan  # noqa: E402
from repro_torch.data.workload import (SLOClass, WorkloadConfig,  # noqa: E402
                                       generate_workload)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import pattern_info  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.fleet import Fleet, Router  # noqa: E402
from repro_torch.serving.request import Request, State  # noqa: E402

MAX_SEQ, PAGE = 96, 16
RTOL, ATOL = 5e-2, 1e-1          # DualEngine's logit tolerance
_PARAMS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: at these widths it is as fast alone, and the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_torch_engine(*, name="e0", d_model=32, heads=2, layers=8, d_ff=64,
                    vocab=128, max_batch=4, max_seq=MAX_SEQ,
                    page_size=PAGE, extra_device_pages=8, host_pages=0,
                    prefix_dedup=False, preemption=False,
                    host_prefix_cache_pages=0, role="mixed"):
    """A port engine on the CPU sized like ``tests/_engine_builders.py``'s
    ``mk_reduced_engine``: HBM for every weight unit plus
    ``extra_device_pages`` KV pages, a host tier of ``host_pages``, records
    from the A10 preset in model mode. Every engine of one width gets the
    same weights (seed 0), as every reference engine does."""
    cfg = reduce_config(get_config("qwen2.5-3b"), d_model=d_model,
                        heads=heads, layers=layers, d_ff=d_ff, vocab=vocab)
    model = build_model(cfg)
    an = PerformanceAnalyzer(cfg, A10, measure="model", device="cpu")
    page_bytes = page_size * max(costs.kv_cache_bytes(
        cfg, 1, 1, model.virtual_kv), 1)
    _, units = pattern_info(cfg)
    hbm = (OffloadPlan(units, NO_OFFLOAD).device_bytes(
        costs.unit_weight_bytes(cfg)) + extra_device_pages * page_bytes)
    slos = [0.002 * k for k in range(1, 30)]
    rec_p = an.generate_record(slos, [1, 2, 4, 8], [16, 32, 64], "prefill")
    rec_d = an.generate_record(slos, [1, 2, 4, 8], [16, 32, 64], "decode")
    key = (d_model, heads, layers, d_ff, vocab)
    if key not in _PARAMS:
        _PARAMS[key] = model.init(torch.Generator().manual_seed(0), "cpu")
    return ServingEngine(
        name, model, A10, rec_p, rec_d, an.layer_times,
        EngineConfig(max_batch=max_batch, max_seq=max_seq,
                     page_size=page_size, hbm_budget_bytes=hbm,
                     host_kv_bytes=host_pages * page_bytes,
                     prefix_dedup=prefix_dedup, preemption=preemption,
                     host_prefix_cache_pages=host_prefix_cache_pages,
                     disk_latency_s=1e-7, role=role, peer_latency_s=1e-7),
        device="cpu", params=_PARAMS[key])


def _mk_instance(name, scale=1):
    """``tests/test_fleet.py``'s instance; ``scale=2`` is the consolidated
    big instance with the pooled capacity of a 2-instance fleet."""
    return mk_torch_engine(
        name=name, max_batch=scale * 4, extra_device_pages=scale * 6,
        host_pages=scale * 40, prefix_dedup=True, preemption=True,
        host_prefix_cache_pages=scale * 10)


def _tenant_reqs(n=20, seed=7):
    wcfg = WorkloadConfig(
        seed=seed, process="poisson", rate_per_s=3000.0,
        mean_rounds=2.0, mean_think_s=0.0005, tenants=2,
        system_prompt_len=48, median_turn_len=12, turn_len_sigma=0.3,
        max_prompt_len=80, mean_output_len=6.0, max_output_len=10,
        vocab_size=128,
        slo_classes=(SLOClass("standard", 4.0, 0.05, weight=1.0),))
    return generate_workload(wcfg, n)


def _clone(reqs, cls=Request):
    return [cls(rid=r.rid, prompt=r.prompt.copy(),
                max_new_tokens=r.max_new_tokens, ttft_slo_s=r.ttft_slo_s,
                tpot_slo_s=r.tpot_slo_s, arrival_s=r.arrival_s,
                tenant=r.tenant) for r in reqs]


def _gen_tokens(engines):
    return {r.rid: tuple(r.generated) for e in engines for r in e.finished}


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        Router("fastest_first")


def test_fleet_bitwise_vs_big_instance_and_round_robin():
    """The same workload served by a 2-instance affinity fleet, a
    round-robin fleet and one big instance: the same greedy tokens per
    request, bit for bit; the affinity router routed on real prefix hits;
    every audit passes."""
    reqs = _tenant_reqs()
    aff = Fleet([_mk_instance("aff0"), _mk_instance("aff1")],
                policy="affinity")
    aff.run(_clone(reqs), max_iters=50_000)
    rr = Fleet([_mk_instance("rr0"), _mk_instance("rr1")],
               policy="round_robin")
    rr.run(_clone(reqs), max_iters=50_000)
    big = _mk_instance("big", scale=2)
    big.run(_clone(reqs), max_iters=50_000)

    t_aff, t_rr = _gen_tokens(aff.engines), _gen_tokens(rr.engines)
    t_big = _gen_tokens([big])
    assert len(t_aff) == len(t_rr) == len(t_big) == len(reqs)
    assert t_aff == t_rr == t_big
    assert sum(max(d.hits) for d in aff.router.decisions) > 0
    for fleet in (aff, rr):
        ok, violations = fleet.audit()
        assert ok, violations
    assert big.trace.audit().ok


def test_prefix_reuse_bitwise_across_unequal_lengths():
    """A dedup hit serves KV computed under a different prompt length, and
    the hitter's greedy tokens match a dedup-free engine bit for bit
    (prefills bucket to one shape)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 128, 4 * PAGE).astype(np.int32)
    tails = [rng.integers(0, 128, n).astype(np.int32) for n in (2, 12)]

    def reqs():
        return [Request(rid=i, prompt=np.concatenate([prefix, t]),
                        max_new_tokens=8, ttft_slo_s=5.0, tpot_slo_s=1.0)
                for i, t in enumerate(tails)]

    tokens = {}
    for dedup in (True, False):
        eng = mk_torch_engine(name=f"dedup_{dedup}", max_batch=2,
                              extra_device_pages=16, host_pages=8,
                              prefix_dedup=dedup)
        eng.run(reqs(), max_iters=2_000, submit_all=True)
        assert len(eng.finished) == 2
        tokens[dedup] = _gen_tokens([eng])
    assert tokens[True] == tokens[False]


def _manual_park(eng, req):
    """Park an ACTIVE request the way ``_apply_preemptions`` does, so the
    migration moment is deterministic."""
    slot = req.slot
    moves = eng.kv.park(req.rid)
    assert moves is not None
    ops.copy_pages_to_host(eng.pool, [m.src_page for m in moves],
                           eng.host_pool, [m.dst_page for m in moves])
    req.state = State.PREEMPTED
    req.preempt_count += 1
    req.parked_at_s = eng.clock_s
    eng.trace.event("park", req.rid, eng.clock_s, slot=slot)
    req.next_token = int(eng.tokens[slot])
    req.resume_pos = int(eng.pos[slot])
    req.slot = -1
    eng.active[slot] = False
    eng.slot_req[slot] = None
    eng.scheduler.preempted.append(req)


def _migration_scenario(e0, e1, fleet, cls, rng):
    """``test_cross_instance_migration_resumes_bitwise``'s moves: a victim
    prefills and decodes a few steps on e0, parks, a waiter keeps e0
    overloaded, the fleet migrates the victim to e1, and the fleet serves
    the rest. Returns the victim."""
    prompt = rng.integers(0, 128, 40).astype(np.int32)
    victim = cls(rid=0, prompt=prompt, max_new_tokens=12, ttft_slo_s=5.0,
                 tpot_slo_s=1.0)
    e0.submit(victim)
    for _ in range(5):
        e0.step()
    assert victim.state.name == "DECODING" and len(victim.generated) >= 3
    _manual_park(e0, victim) if cls is Request else _ref_park(e0, victim)
    e0.submit(cls(rid=1, prompt=rng.integers(0, 128, 16).astype(np.int32),
                  max_new_tokens=4, ttft_slo_s=5.0, tpot_slo_s=1.0,
                  arrival_s=e0.clock_s))
    fleet._maybe_migrate(e0)
    return victim


def test_cross_instance_migration_resumes_bitwise():
    """A parked request migrates to the less-loaded peer mid-decode and
    finishes there with the tokens of a never-migrated engine; the ticket's
    bytes conserve fleet-wide and both audits stay clean."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 128, 40).astype(np.int32)
    ref_eng = mk_torch_engine(name="ref", extra_device_pages=12,
                              host_pages=20, preemption=True)
    ref = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12,
                  ttft_slo_s=5.0, tpot_slo_s=1.0)
    ref_eng.run([ref], max_iters=200)
    assert len(ref.generated) == 12

    e0, e1 = _mk_instance("m0"), _mk_instance("m1")
    fleet = Fleet([e0, e1], policy="affinity")
    victim = _migration_scenario(e0, e1, fleet, Request,
                                 np.random.default_rng(11))
    assert [(m["src"], m["dst"]) for m in fleet.migrations] == [("m0",
                                                                 "m1")]
    assert e0.n_migrated_out == 1 and e1.n_migrated_in == 1
    assert e0.mig_out_bytes_total == e1.mig_in_bytes_total > 0
    fleet.run([], max_iters=5_000)
    assert {r.rid for r in e1.finished} == {0}
    assert {r.rid for r in e0.finished} == {1}
    assert tuple(victim.generated) == tuple(ref.generated)
    ok, violations = fleet.audit()
    assert ok, violations


def test_queued_request_reroutes_to_drained_peer():
    """A request queued behind a long-runner re-scores after every fleet
    step and moves to the peer that has since drained (no KV moved)."""
    rng = np.random.default_rng(9)

    def mk(name):
        return mk_torch_engine(name=name, max_batch=1, extra_device_pages=8,
                               host_pages=20, preemption=True)

    e0, e1 = mk("q0"), mk("q1")
    fleet = Fleet([e0, e1], policy="affinity")
    long_r = Request(rid=0, prompt=rng.integers(0, 128, 24).astype(np.int32),
                     max_new_tokens=24, ttft_slo_s=5.0, tpot_slo_s=1.0)
    short = Request(rid=1, prompt=rng.integers(0, 128, 16).astype(np.int32),
                    max_new_tokens=2, ttft_slo_s=5.0, tpot_slo_s=1.0)
    waiter = Request(rid=2, prompt=rng.integers(0, 128, 16).astype(np.int32),
                     max_new_tokens=4, ttft_slo_s=5.0, tpot_slo_s=1.0)
    fleet.run([long_r, short, waiter], max_iters=5_000, submit_all=True)
    assert len(_gen_tokens(fleet.engines)) == 3
    moved = [m for m in fleet.reroutes if m["rid"] == 2]
    assert moved and moved[-1]["dst"] == "q1"
    assert any(r.rid == 2 for r in e1.finished)
    ok, violations = fleet.audit()
    assert ok, violations


def test_migration_rollback_when_peer_full():
    """A peer without a host pool is never a migration target: the
    request stays parked on its instance and finishes there."""
    rng = np.random.default_rng(5)
    e0 = _mk_instance("r0")
    e1 = mk_torch_engine(name="r1", extra_device_pages=12, host_pages=0,
                         preemption=True)
    fleet = Fleet([e0, e1], policy="affinity")
    victim = Request(rid=0, prompt=rng.integers(0, 128, 40).astype(np.int32),
                     max_new_tokens=10, ttft_slo_s=5.0, tpot_slo_s=1.0)
    e0.submit(victim)
    for _ in range(4):
        e0.step()
    _manual_park(e0, victim)
    e0.submit(Request(rid=1,
                      prompt=rng.integers(0, 128, 16).astype(np.int32),
                      max_new_tokens=4, ttft_slo_s=5.0, tpot_slo_s=1.0,
                      arrival_s=e0.clock_s))
    fleet._maybe_migrate(e0)
    assert not fleet.migrations and e0.n_migrated_out == 0
    fleet.run([], max_iters=5_000)
    assert {r.rid for r in e0.finished} == {0, 1}
    ok, violations = fleet.audit()
    assert ok, violations


def test_migration_ticket_carries_the_host_bits():
    """Export then import moves the parked request's host frames bit for
    bit into freshly claimed frames of the peer (the port's payload is a
    torch copy of the frames, token order)."""
    rng = np.random.default_rng(2)
    e0, e1 = _mk_instance("t0"), _mk_instance("t1")
    victim = Request(rid=0, prompt=rng.integers(0, 128, 40).astype(np.int32),
                     max_new_tokens=10, ttft_slo_s=5.0, tpot_slo_s=1.0)
    e0.submit(victim)
    for _ in range(3):
        e0.step()
    _manual_park(e0, victim)
    src = [e0.host_pool[p].clone() for p in e0.kv.export_parked(0)]
    req, ticket = e0.export_parked_request(0)
    assert ticket.n_pages == len(src) and ticket.payload.shape[0] == len(src)
    assert e1.import_parked_request(req, ticket)
    dst = [e1.host_pool[r.page] for r in e1.kv.refs(0)]
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(src, dst))


# ---------------------------------------------------------------------------
# Lockstep against the reference's JAX fleet
# ---------------------------------------------------------------------------


def _ref_park(eng, req):
    """``tests/test_fleet.py::_manual_park`` on a reference engine."""
    from repro.kernels import ops as jops
    slot = req.slot
    moves = eng.kv.park(req.rid)
    assert moves is not None
    jops.copy_pages_to_host(eng.pool, [m.src_page for m in moves],
                            eng.host_pool, [m.dst_page for m in moves])
    req.state = type(req.state).PREEMPTED
    req.preempt_count += 1
    req.parked_at_s = eng.clock_s
    eng.trace.event("park", req.rid, eng.clock_s, slot=slot)
    req.next_token = int(eng.tokens[slot])
    req.resume_pos = int(eng.pos[slot])
    req.slot = -1
    eng.active[slot] = False
    eng.slot_req[slot] = None
    eng.scheduler.preempted.append(req)


class FleetLockstep:
    """Records each reference engine's emitted logits per request (from
    ``prefill_log`` and ``last_decode`` after every step) and teacher-forces
    the port engines' greedy picks with them under the DualEngine rule."""

    def __init__(self, jengs, tengs):
        self.emitted: dict[int, list] = defaultdict(list)
        self.reqs: dict[int, object] = {}
        self.compares = self.ties = 0
        for e in jengs:
            e.step = self._recording(e, e.step)
        for e in tengs:
            e._greedy = self._forced

    def track(self, reqs) -> None:
        self.reqs.update({r.rid: r for r in reqs})

    def _recording(self, eng, step):
        def run(*args, **kwargs):
            before = {rid: len(r.generated) for rid, r in self.reqs.items()}
            step(*args, **kwargs)
            grown = [rid for rid, r in self.reqs.items()
                     if len(r.generated) > before[rid]]
            for req, _slot, lg in eng.prefill_log:
                self.emitted[req.rid].append(lg)
            if eng.last_decode is not None:
                for slot in np.flatnonzero(eng.last_decode["active"]):
                    rid = next(r for r in grown if self.reqs[r].slot == slot)
                    self.emitted[rid].append(eng.last_decode["logits"][slot])
        return run

    def _forced(self, req, logits) -> int:
        want = self.emitted[req.rid].pop(0)
        np.testing.assert_allclose(logits, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"logits of rid {req.rid}")
        got, tok = int(np.argmax(logits)), int(np.argmax(want))
        self.compares += 1
        if got != tok:
            tie = ATOL + RTOL * abs(float(want[tok]))
            assert (want[tok] - want[got] <= tie
                    and logits[got] - logits[tok] <= tie), \
                f"rid {req.rid}: token {got} != {tok} beyond a tie"
            self.ties += 1
        return tok


def assert_fleets_equal(jfleet, tfleet, ls: FleetLockstep) -> None:
    """Everything the policy layer produced, equal; tokens forced equal
    within the tie bound."""
    asdict = dataclasses.asdict
    assert ([asdict(d) for d in tfleet.router.decisions]
            == [asdict(d) for d in jfleet.router.decisions])
    assert tfleet.migrations == jfleet.migrations
    assert tfleet.handoffs == jfleet.handoffs
    assert tfleet.reroutes == jfleet.reroutes
    for je, te in zip(jfleet.engines, tfleet.engines):
        assert ([asdict(it) for it in te.trace.iterations]
                == [asdict(it) for it in je.trace.iterations]), te.name
        assert ([asdict(ev) for ev in te.trace.events]
                == [asdict(ev) for ev in je.trace.events]), te.name
        assert te._trace_footer() == je._trace_footer(), te.name
        assert ({r.rid: r.generated for r in te.finished}
                == {r.rid: r.generated for r in je.finished}), te.name
    assert tfleet.summary() == jfleet.summary()
    assert all(not q for q in ls.emitted.values())
    assert ls.compares > 0 and ls.ties <= max(1, 0.05 * ls.compares)
    for fleet in (jfleet, tfleet):
        ok, violations = fleet.audit()
        assert ok, violations


def ref_and_port_instances(specs):
    """(reference engines, port engines on their weights): ``specs`` are
    ``mk_reduced_engine`` keywords per instance."""
    pytest.importorskip("jax")
    from _engine_builders import mk_reduced_engine
    from test_torch_engine import mk_port_engine

    dims = dict(d_model=32, heads=2, layers=8, d_ff=64, vocab=128,
                batches=(1, 2, 4), seqs=(16, 32, 64))
    jengs, tengs = [], []
    for spec in specs:
        build = dict(max_seq=MAX_SEQ, page_size=PAGE, **dims, **spec)
        jeng, _ = mk_reduced_engine(**build)
        jengs.append(jeng)
        tengs.append(mk_port_engine(jeng, **build))
    return jengs, tengs


def test_fleet_lockstep_with_migration_against_reference():
    """A 2-instance affinity fleet on both sides, one request migrated from
    the overloaded instance mid-decode, then a burst of tenant traffic
    routed by the affinity router: decisions, migrations, records and
    counters equal; tokens under the tie rule."""
    from repro.serving.fleet import Fleet as JFleet
    from repro.serving.request import Request as JRequest

    inst = dict(max_batch=4, extra_device_pages=6, host_pages=40,
                prefix_dedup=True, preemption=True,
                host_prefix_cache_pages=10)
    jengs, tengs = ref_and_port_instances([dict(name="m0", **inst),
                                           dict(name="m1", **inst)])
    ls = FleetLockstep(jengs, tengs)
    jfleet = JFleet(jengs, policy="affinity")
    tfleet = Fleet(tengs, policy="affinity")
    later = _tenant_reqs(n=5, seed=3)
    for f, cls in ((jfleet, JRequest), (tfleet, Request)):
        rng = np.random.default_rng(11)
        ls.track([])
        e0 = f.engines[0]
        victim = _migration_scenario_tracked(e0, f, cls, rng, ls)
        assert len(f.migrations) == 1, f.migrations
        burst = _clone(later, cls)
        for r in burst:
            r.rid += 2
            r.arrival_s += e0.clock_s
        ls.track(burst)
        f.run(burst, max_iters=50_000)
        assert victim.generated and victim.state.name == "FINISHED"
    assert_fleets_equal(jfleet, tfleet, ls)


def _migration_scenario_tracked(e0, fleet, cls, rng, ls):
    """``_migration_scenario`` with every request registered for the
    lockstep's emission records as it is submitted."""
    submit = e0.submit

    def tracked(req):
        ls.track([req])
        submit(req)

    e0.submit = tracked
    try:
        return _migration_scenario(e0, None, fleet, cls, rng)
    finally:
        del e0.submit
