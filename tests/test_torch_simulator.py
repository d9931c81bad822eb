"""The port's copies of the two-stream simulator (``core/simulator.py``) and
the paper's baselines (``core/baselines.py``) against the reference's. Both
are pure Python, so the same inputs must give *equal* values. The cases
come from numpy seeds; then the paper-shape checks of
``tests/test_core_algebra.py`` run on the port's modules."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import baselines as JB
from repro.core import hardware as JH
from repro.core import interval as JI
from repro.core import simulator as JS
from repro_torch.core import baselines as B
from repro_torch.core import hardware as H
from repro_torch.core import interval as I
from repro_torch.core import simulator as S
from repro_torch.core.hardware import A10
from repro_torch.core.interval import (LayerTimes, OffloadPlan,
                                       min_feasible_interval)

SEEDS = range(8)


def _case(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    return {
        "t_compute_s": [float(x) for x in rng.uniform(1e-4, 5e-3, n)],
        "t_transfer_s": float(rng.uniform(1e-4, 2e-2)),
        "t_rest_s": float(rng.uniform(0.0, 2e-3)),
        "interval": int(rng.integers(1, n + 2)),     # n + 1: nothing offloaded
        "lookahead_groups": int(rng.integers(1, 3)),
        "kv_in_s": float(rng.uniform(0.0, 5e-3)) * int(rng.integers(0, 2)),
        "kv_out_s": float(rng.uniform(0.0, 5e-3)) * int(rng.integers(0, 2)),
        "fraction": float(rng.uniform(0.0, 1.0)),
        "bw_fraction": float(rng.uniform(0.2, 1.0)),
    }


def _schedules(mod, c: dict) -> dict:
    return {
        "select_n": mod.schedule_for_interval(
            c["t_compute_s"], c["interval"], c["t_transfer_s"], c["t_rest_s"],
            lookahead_groups=c["lookahead_groups"], kv_in_s=c["kv_in_s"],
            kv_out_s=c["kv_out_s"]),
        "deepspeed": mod.schedule_deepspeed(
            c["t_compute_s"], c["t_transfer_s"], c["t_rest_s"]),
        "flexgen": mod.schedule_flexgen(
            c["t_compute_s"], c["fraction"], c["t_transfer_s"],
            c["t_rest_s"]),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_schedules_equal_reference(seed):
    c = _case(seed)
    got, want = _schedules(S, c), _schedules(JS, c)
    for name in want:
        assert dataclasses.astuple(got[name]) == dataclasses.astuple(
            want[name]), name


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_iteration_equals_reference(seed):
    """Every schedule, the Select-N one with its KV terms, at full and at a
    shared bandwidth."""
    c = _case(seed)
    got, want = _schedules(S, c), _schedules(JS, c)
    for name in want:
        for bw in (1.0, c["bw_fraction"]):
            assert (S.simulate_iteration(got[name], bw)
                    == JS.simulate_iteration(want[name], bw)), (name, bw)


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_shared_bus_equals_reference(seed):
    c = _case(seed)
    rng = np.random.default_rng(100 + seed)
    got = list(_schedules(S, c).values())
    want = list(_schedules(JS, c).values())
    demands = [float(x) for x in rng.uniform(0.1, 1.0, len(got))]
    fractions = [float(x) for x in rng.uniform(0.2, 1.0, len(got))]
    for kwargs in ({}, {"link_bw_fraction_each": fractions},
                   {"total_bw": 1.2, "demands": demands},
                   {"total_bw": 10.0, "demands": demands}):
        assert (S.simulate_shared_bus(got, **kwargs)
                == JS.simulate_shared_bus(want, **kwargs)), kwargs


@pytest.mark.parametrize("seed", SEEDS)
def test_flexgen_and_plans_equal_reference(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(2, 80))
    args = (float(rng.uniform(1e-4, 1e-2)), float(rng.uniform(1e-4, 3e-2)),
            n, int(rng.integers(1, 1 << 30)), float(rng.uniform(0, 1e-3)))
    times, jtimes = I.LayerTimes(*args), JI.LayerTimes(*args)
    slo = float(rng.uniform(0.5, 3.0)) * times.t_iter_no_offload_s
    layer_flops = float(rng.uniform(0.05, 1.5)) * 2e-3 * 125e12
    sharers = int(rng.integers(1, 4))
    for hw, jhw in ((H.A10, JH.A10), (H.A10_CALIBRATED, JH.A10_CALIBRATED),
                    (H.TPU_V5E, JH.TPU_V5E)):
        got = B.flexgen_decision(times, hw, slo, layer_flops, sharers)
        want = JB.flexgen_decision(jtimes, jhw, slo, layer_flops, sharers)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert (B.flexgen_host_bytes(times, got)
                == JB.flexgen_host_bytes(jtimes, want))
        assert (B.flexgen_equivalent_interval(times, got)
                == JB.flexgen_equivalent_interval(jtimes, want))
    for plan in ("naive_plan", "deepspeed_plan"):
        assert (dataclasses.astuple(getattr(B, plan)(n))
                == dataclasses.astuple(getattr(JB, plan)(n)))


# ---------------------------------------------------------------------------
# tests/test_core_algebra.py's paper-shape checks, on the port's modules
# ---------------------------------------------------------------------------


def test_deepspeed_slowdown_matches_paper_shape():
    """When transfer >> compute (paper Fig. 2: 13.8x at decode), DeepSpeed's
    latency approaches L*t_transfer, i.e. t_t/t_c-fold slowdown."""
    tc, tt, n = 1e-3, 13.8e-3, 32
    sim = S.simulate_iteration(S.schedule_deepspeed([tc] * n, tt))
    assert sim["latency_s"] >= n * tt
    assert 12.0 <= sim["latency_s"] / (n * tc) <= 16.0


def test_selectn_meets_slo_where_deepspeed_fails():
    tc, tt, n = 1e-3, 6e-3, 32
    times = LayerTimes(tc, tt, n, 1 << 20)
    slo = 1.25 * times.t_iter_no_offload_s
    ds = S.simulate_iteration(S.schedule_deepspeed([tc] * n, tt))["latency_s"]
    assert ds > slo
    i = min_feasible_interval(times, slo)
    sn = S.simulate_iteration(
        S.schedule_for_interval([tc] * n, i, tt))["latency_s"]
    assert sn <= slo
    assert OffloadPlan(n, i).num_offloaded > 0


def test_contention_oversubscription_stretches_transfers():
    tc, tt, n = 1e-3, 4e-3, 16
    s1 = S.schedule_for_interval([tc] * n, 4, tt)
    s2 = S.schedule_for_interval([tc] * n, 4, tt)
    alone = S.simulate_iteration(s1)["latency_s"]
    rate = OffloadPlan(n, 4).link_bytes_per_iter(100) / alone
    shared = S.simulate_shared_bus([s1, s2], total_bw=1.2 * rate,
                                   demands=[rate, rate])
    assert all(r["latency_s"] > alone for r in shared)


def test_flexgen_underoffloads_vs_selectn():
    """Observations #2/#3: worst-case bandwidth assumption + peak-FLOPs
    estimation make FlexGen offload less than Select-N at the same SLO
    (the paper's §5.3 setting: zero slack, decode, two instances)."""
    tc_real = 2e-3
    layer_flops = A10.peak_flops * tc_real * 0.35   # real kernels at 35% peak
    times = LayerTimes(tc_real, 4e-3, 32, 400 << 20, t_rest_s=0.0)
    slo = times.t_iter_no_offload_s
    fg = B.flexgen_decision(times, A10, slo, layer_flops, n_bus_sharers=2)
    sn_interval = min_feasible_interval(times, slo)
    sn_host = OffloadPlan(32, sn_interval).host_bytes(times.layer_bytes)
    assert B.flexgen_host_bytes(times, fg) < sn_host
    assert A10.peak_exec_time(layer_flops) < tc_real
    assert fg.est_iter_s <= slo * (1 + 1e-9)
    assert B.flexgen_equivalent_interval(times, fg) >= sn_interval
