"""The port's disaggregated prefill/decode fleet on the CPU:
``tests/differential/test_disagg.py``'s contracts on port engines at the
same reduced widths, and a lockstep against the reference's JAX fleet.

Role-typed instances change where tokens are computed and when bytes move,
never the numbers: a 1 prefill + 1 decode fleet, a 2-instance affinity
fleet and one pooled instance give the same greedy tokens, bit for bit;
every SLO is met on the modeled clock; handed-off bytes conserve per link
and fleet-wide. The lockstep runs a disaggregated fleet on both sides,
with one handoff forced and rolled back before the run, and holds the
router's decisions, the handoffs, every instance's records and counters
equal, tokens under the ``DualEngine`` tie rule.
"""
from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.data.workload import (SLOClass, WorkloadConfig,  # noqa: E402
                                       generate_workload)
from repro_torch.serving.fleet import Fleet  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

from test_torch_fleet import (FleetLockstep, _clone,  # noqa: E402
                              assert_fleets_equal, mk_torch_engine,
                              ref_and_port_instances)
from test_torch_fleet import one_thread  # noqa: E402,F401  (autouse)


def _mk_instance(name, role="mixed", scale=1):
    return mk_torch_engine(name=name, max_batch=scale * 4,
                           extra_device_pages=scale * 8,
                           host_pages=scale * 40, preemption=True, role=role)


def _workload(n=14, seed=23):
    wcfg = WorkloadConfig(
        seed=seed, process="poisson", rate_per_s=3000.0,
        mean_rounds=1.0, mean_think_s=0.0005, tenants=2,
        system_prompt_len=32, median_turn_len=12, turn_len_sigma=0.3,
        max_prompt_len=72, mean_output_len=6.0, max_output_len=10,
        vocab_size=128,
        slo_classes=(SLOClass("standard", 4.0, 0.05, weight=1.0),))
    return generate_workload(wcfg, n)


def _tokens(engines):
    return {r.rid: tuple(r.generated) for e in engines for r in e.finished}


def test_disagg_bitwise_vs_affinity_vs_pooled():
    reqs = _workload()
    disagg = Fleet([_mk_instance("p0", role="prefill"),
                    _mk_instance("d0", role="decode")], policy="affinity")
    s_dis = disagg.run(_clone(reqs), max_iters=50_000)
    aff = Fleet([_mk_instance("a0"), _mk_instance("a1")], policy="affinity")
    s_aff = aff.run(_clone(reqs), max_iters=50_000)
    pooled = _mk_instance("pooled", scale=2)
    pooled.run(_clone(reqs), max_iters=50_000)

    t_dis, t_aff = _tokens(disagg.engines), _tokens(aff.engines)
    t_pool = _tokens([pooled])
    assert len(t_dis) == len(t_aff) == len(t_pool) == len(reqs)
    assert t_dis == t_aff == t_pool

    # every request with decode work prefilled on p0, was handed off
    # through the PEER tier and decoded on d0
    n_decode = sum(1 for r in reqs if r.max_new_tokens > 1)
    assert s_dis["handoffs"] == n_decode
    assert s_dis["per_instance"]["p0"]["finished"] == len(reqs) - n_decode
    assert s_dis["per_instance"]["d0"]["finished"] == n_decode
    assert s_dis["per_instance"]["p0"]["handoffs_out"] == n_decode
    assert s_dis["per_instance"]["d0"]["handoffs_in"] == n_decode
    assert s_dis["handoff_bytes"] > 0
    assert s_dis["slo_ok"] and s_aff["slo_ok"]
    for fleet in (disagg, aff):
        ok, violations = fleet.audit()
        assert ok, violations
    assert pooled.trace.audit().ok


def test_disagg_refused_handoff_rolls_back_then_flushes():
    """A decode instance too small for any ticket refuses the import; the
    forced export rolls back with no peer bytes booked, and the drained
    fleet's flush releases ``hold_resumes`` so the prefill instance decodes
    its stranded set itself, with a mixed engine's tokens."""
    reqs = _workload(n=4, seed=5)
    ref = _mk_instance("ref")
    ref.run(_clone(reqs), max_iters=50_000)

    p0 = _mk_instance("p1", role="prefill")
    d0 = mk_torch_engine(name="d1", max_batch=4, extra_device_pages=8,
                         host_pages=2, preemption=True, role="decode")
    fleet = Fleet([p0, d0], policy="affinity")
    for r in _clone(reqs):
        fleet._submit(r)
    while not p0.scheduler.preempted:
        p0.step()
    rid = p0.scheduler.preempted[0].rid
    out = p0.export_handoff(rid)
    assert out is not None
    got, ticket = out
    assert not d0.import_handoff(got, ticket)
    p0.rollback_handoff(got, ticket)
    assert any(r.rid == rid for r in p0.scheduler.preempted)
    assert p0.kv.pending_peer_out_pages == 0
    assert p0.kv.peer_out_pages_total == 0
    assert p0.handoff_out_bytes_total == 0 and p0.n_handoff_out == 0
    assert d0.kv.pending_peer_in_pages == 0 and d0.n_handoff_in == 0

    s = fleet.run([], max_iters=50_000)
    assert s["handoffs"] == 0
    assert not p0.scheduler.hold_resumes
    assert _tokens(fleet.engines) == _tokens([ref])
    assert {r.rid for r in p0.finished} == {r.rid for r in reqs}
    ok, violations = fleet.audit()
    assert ok, violations


def test_disagg_lockstep_against_reference():
    """A 1 prefill + 1 decode fleet on both sides. Before the run, the
    first parked prefill is exported and rolled back by hand (a refusal's
    path); then the fleet hands every request off."""
    from repro.serving.fleet import Fleet as JFleet
    from repro.serving.request import Request as JRequest

    inst = dict(max_batch=4, extra_device_pages=8, host_pages=40,
                preemption=True)
    jengs, tengs = ref_and_port_instances([
        dict(name="p0", role="prefill", **inst),
        dict(name="d0", role="decode", **inst)])
    ls = FleetLockstep(jengs, tengs)
    reqs = _workload(n=6, seed=29)
    fleets = []
    for engines, cls, fleet_cls in ((jengs, JRequest, JFleet),
                                    (tengs, Request, Fleet)):
        fleet = fleet_cls(engines, policy="affinity")
        batch = _clone(reqs, cls)
        ls.track(batch)
        p0 = engines[0]
        for r in batch:
            fleet._submit(r)
        while not p0.scheduler.preempted:
            p0.step()
        got, ticket = p0.export_handoff(p0.scheduler.preempted[0].rid)
        p0.rollback_handoff(got, ticket)
        s = fleet.run([], max_iters=50_000)
        assert s["handoffs"] == sum(r.max_new_tokens > 1 for r in reqs)
        assert s["slo_ok"]
        fleets.append(fleet)
    assert any(ev.kind == "handoff_rollback"
               for ev in fleets[1].engines[0].trace.events)
    assert_fleets_equal(*fleets, ls)
    assert np.all([e.n_handoff_in for e in fleets[1].engines]
                  == [0, len(fleets[1].handoffs)])
