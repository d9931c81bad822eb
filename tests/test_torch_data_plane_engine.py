"""The port's engine with the disk (NVMe) KV tier and the copy-stage data
plane, in lockstep with the reference engine on the CPU.

The traces are those of ``tests/differential/test_async_data_plane.py``
and ``tests/differential/test_disk_tier.py``, at those tests' own reduced
widths (``WIDTHS``; at the narrower stack of ``test_torch_engine.DIMS`` the
scheduler admits the short requests without parking anyone, so no page
would reach the disk): parks that overflow the host pool retire
to disk, resumes stage disk -> host -> device, and the async plane queues
every copy until the next iteration boundary (host->disk retirements on
its worker thread, a staged prefetch ahead of the oldest parked request's
resume). Records, events, footers (the staged-page counters included),
scheduler stats and the modeled clock must equal the reference's, and the
port's audit must be clean.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.interval import iter_time_with_interval_kv  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402

from _engine_builders import mk_reduced_engine  # noqa: E402
from test_torch_engine import (BATCHES, SEQS, Lockstep,  # noqa: E402
                               mk_port_engine)

# the widths of tests/_engine_builders.mk_reduced_engine's defaults
WIDTHS = dict(d_model=32, heads=2, layers=8, d_ff=64, vocab=128)


def _tpot_short(eng) -> float:
    """A TPOT that affords one streamed page per iteration but not two
    (``test_async_data_plane._tpot_short``)."""
    pb = eng.kv.page_bytes
    dt_1 = iter_time_with_interval_kv(eng.times_fn(4, 48, "decode"),
                                      eng.interval, 1 * pb)
    dt_2 = iter_time_with_interval_kv(eng.times_fn(1, 48, "decode"),
                                      eng.interval, 2 * pb)
    assert dt_1 < dt_2
    return (dt_1 + dt_2) / 2


def _trace(ls: Lockstep, seed: int, reqs_first, reqs_later) -> int:
    """Submit ``reqs_first``, step twice, submit ``reqs_later`` (each entry
    (rid, prompt_len, new_tokens, tpot or None for the short TPOT))."""
    rng = np.random.default_rng(seed)
    tpot = _tpot_short(ls.j)

    def submit(rid, plen, new, t):
        kw = dict(rid=rid, prompt=rng.integers(0, 100, plen).astype(np.int32),
                  max_new_tokens=new, ttft_slo_s=10.0,
                  tpot_slo_s=tpot if t is None else t)
        ls.submit(JRequest(**kw), TRequest(**kw))

    for r in reqs_first:
        submit(*r)
    ls.step()
    ls.step()
    for r in reqs_later:
        submit(*r)
    return len(reqs_first) + len(reqs_later)


# the fig18 pressure trace: the host pool holds exactly one victim's
# spill, so parking it forces a disk retirement
PRESSURE = dict(build=dict(extra_device_pages=4, host_pages=2, disk_pages=16),
                first=[(9, 4, 12, 1e-3), (0, 16, 16, 1e-3)],
                later=[(i, 4, 4, None) for i in range(1, 5)], seed=11)
# the preemption burst with ample host: parks and resumes ride the plane's
# d2h/h2d legs, no NVMe traffic
BURST = dict(build=dict(extra_device_pages=4, host_pages=64, disk_pages=16),
             first=[(0, 4, 12, 1e-3), (1, 16, 16, 1e-3)],
             later=[(i, 4, 4, None) for i in range(2, 8)], seed=3)

CASES = {
    "disk_pressure_sync": dict(PRESSURE, async_plane=False),
    "disk_pressure_async": dict(PRESSURE, async_plane=True),
    "disk_preempt_burst_async": dict(BURST, async_plane=True),
    "disk_backing_file": dict(PRESSURE, async_plane=True, backing=True),
}


def _lockstep(name, spec, tmp_path=None, disk_pages=None):
    build = dict(max_batch=4, max_seq=48, page_size=8, preemption=True,
                 batches=BATCHES, seqs=SEQS, **WIDTHS)
    build.update(spec["build"])
    if disk_pages is not None:
        build["disk_pages"] = disk_pages
    build["async_data_plane"] = spec.get("async_plane", False)
    port_ecfg = None
    if spec.get("backing"):
        build["disk_backing_path"] = str(tmp_path / "ref_disk.bin")
        port_ecfg = {"disk_backing_path": str(tmp_path / "port_disk.bin")}
    jeng, _ = mk_reduced_engine(name=name, **build)
    teng = mk_port_engine(jeng, port_ecfg=port_ecfg, **build)
    ls = Lockstep(jeng, teng)
    n = _trace(ls, spec["seed"], spec["first"], spec["later"])
    ls.run()
    _assert_equal(ls, n)
    return ls


def _assert_equal(ls: Lockstep, n: int) -> None:
    jeng, teng = ls.j, ls.t
    assert len(teng.finished) == n and not teng.rejected
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    for jr, tr in zip(jeng.finished, teng.finished):
        assert tr.generated == jr.generated       # after teacher forcing
        assert tr.metrics() == jr.metrics()
    assert [dataclasses.asdict(r) for r in teng.trace.iterations] == \
        [dataclasses.asdict(r) for r in jeng.trace.iterations]
    assert [dataclasses.asdict(e) for e in teng.trace.events] == \
        [dataclasses.asdict(e) for e in jeng.trace.events]
    assert teng.trace.totals() == jeng.trace.totals()
    assert teng._trace_footer() == jeng._trace_footer()
    assert teng.scheduler.stats == jeng.scheduler.stats
    assert teng.clock_s == jeng.clock_s
    assert teng.prefetch_pages_total == jeng.prefetch_pages_total
    teng.kv.check_invariants()
    report = teng.trace.audit()
    assert report.ok, report.violations
    assert ls.compares > 0 and ls.ties <= max(1, 0.05 * ls.compares)
    foot = teng.trace.footer()
    assert foot["staged_inflight_pages"] == 0
    assert foot["staged_issued_pages_total"] \
        == foot["staged_completed_pages_total"] > 0
    for eng in (teng, jeng):                 # every pool is empty again
        assert eng.kv.device.used_pages == eng.kv.host.used_pages \
            == eng.kv.disk.used_pages == 0


@pytest.mark.parametrize("case", list(CASES))
def test_disk_tier_lockstep(case, tmp_path):
    spec = CASES[case]
    ls = _lockstep(case, spec, tmp_path)
    teng = ls.t
    stats = teng.scheduler.stats
    assert stats["preemptions"] > 0
    if spec is CASES["disk_preempt_burst_async"]:
        assert teng.kv.disk_out_pages_total == 0
    else:
        assert stats["disk_demotions"] > 0 and stats["disk_stagings"] > 0
        assert teng.kv.disk_out_pages_total > 0
        assert teng.disk_kv_peak_pages > 0
    if spec["async_plane"] and teng.kv.disk_out_pages_total:
        # on the pressure trace the plane deferred work past the boundary
        # that issued it (retirements on the worker, the staged prefetch)
        assert any(r.staged_issued_pages != r.staged_completed_pages
                   for r in teng.trace.iterations)
        assert teng.prefetch_pages_total >= 1
    elif not spec["async_plane"]:
        for r in teng.trace.iterations:
            assert r.staged_issued_pages == r.staged_completed_pages
    if spec.get("backing"):
        # the disk pool is a mapping of the port's own file: its bf16 bits
        # are the file's bytes, and the pressure trace wrote pages there
        raw = np.fromfile(tmp_path / "port_disk.bin", dtype=np.uint16)
        bits = teng.disk_pool.view(torch.int16).numpy().view(np.uint16)
        assert raw.size == bits.size and np.array_equal(raw, bits.ravel())
        assert np.count_nonzero(raw) > 0


def test_disk_idle_equals_two_tier_run():
    """A disk tier that never engages (ample host) changes nothing: the
    three-tier port engine locksteps the reference, and without teacher
    forcing it gives the same tokens, modeled clock, events and records as
    the port's two-tier engine on the same trace, apart from the plane's
    own staged-page counters (the disk tier wires parks and resumes
    through the plane) and the disk pool's size in the occupancy."""
    ls = _lockstep("disk_idle", dict(BURST, async_plane=False), disk_pages=32)
    assert ls.t.disk_kv_peak_pages == 0
    assert ls.t.kv.disk_in_pages_total == ls.t.kv.disk_out_pages_total == 0
    assert ls.t.scheduler.stats["preemptions"] > 0

    runs = {}
    for disk in (0, 32):
        build = dict(max_batch=4, max_seq=48, page_size=8, preemption=True,
                     batches=BATCHES, seqs=SEQS, **WIDTHS)
        build.update(BURST["build"], disk_pages=disk)
        jeng, _ = mk_reduced_engine(name="idle", **build)
        teng = mk_port_engine(jeng, **build)
        rng = np.random.default_rng(BURST["seed"])
        tpot = _tpot_short(teng)
        mk = lambda rid, plen, new, t: TRequest(
            rid=rid, prompt=rng.integers(0, 100, plen).astype(np.int32),
            max_new_tokens=new, ttft_slo_s=10.0,
            tpot_slo_s=tpot if t is None else t)
        for r in BURST["first"]:
            teng.submit(mk(*r))
        teng.step()
        teng.step()
        for r in BURST["later"]:
            teng.submit(mk(*r))
        for _ in range(400):
            if not (teng.scheduler.has_work() or teng._active_batch()):
                break
            teng.step()
        assert teng.trace.audit().ok
        runs[disk] = teng
    base, idle = runs[0], runs[32]
    assert idle.data_plane is not None and base.data_plane is None
    assert {r.rid: r.generated for r in idle.finished} == \
        {r.rid: r.generated for r in base.finished}
    assert idle.clock_s == base.clock_s
    assert idle.scheduler.stats == base.scheduler.stats
    assert [dataclasses.asdict(e) for e in idle.trace.events] == \
        [dataclasses.asdict(e) for e in base.trace.events]

    def strip(rec):
        d = dataclasses.asdict(rec)
        del d["staged_issued_pages"], d["staged_completed_pages"]
        del d["occupancy"]["disk"]["total_pages"]       # 32 frames vs none
        return d

    assert len(idle.trace.iterations) == len(base.trace.iterations)
    differ = {k for a, b in zip(idle.trace.iterations, base.trace.iterations)
              for k, v in strip(a).items() if strip(b)[k] != v}
    assert not differ, differ
    assert sum(r.staged_issued_pages for r in idle.trace.iterations) > 0


# ---------------------------------------------------------------------------
# launch/profile_engine.disk_engine: the trace chip_smoke.py runs at full
# width on the card
# ---------------------------------------------------------------------------


def _small_cfg():
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config

    return reduce_config(get_config("qwen2.5-3b"), d_model=256, heads=4,
                         layers=8, d_ff=512, vocab=1024)


def test_disk_engine_trace_sync_equals_async_on_a_small_model(tmp_path):
    """``disk_engine``'s pressure trace on the CPU at a small width: parks
    retire to disk and stage back in both modes, the async run's tokens,
    modeled clock and NVMe traffic equal the sync run's, its staged pages
    are conserved, and every pool ends empty. A third run maps the disk
    pool onto a file and serves the same tokens."""
    from repro_torch.launch.profile_engine import (disk_engine, disk_requests,
                                                   serve_disk_trace)
    from repro_torch.models.model import build_model

    cfg = _small_cfg()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for name, kw in (("sync", {}), ("async", dict(async_plane=True)),
                     ("file", dict(backing_path=str(tmp_path / "d.bin")))):
        eng = disk_engine("cpu", params=params, cfg=cfg, **kw)
        out = serve_disk_trace(eng, *disk_requests(
            eng, np.random.default_rng(5)))
        assert out["finished"] == 6 and not out["rejected"] and out["slo_ok"]
        assert out["preemptions"] > 0 and out["disk_demotions"] > 0
        assert out["disk_stagings"] > 0 and eng.kv.disk_out_pages_total > 0
        assert eng.trace.audit().ok
        assert eng.kv.device.used_pages == eng.kv.host.used_pages \
            == eng.kv.disk.used_pages == 0
        runs[name] = eng
    sync, asyn = runs["sync"], runs["async"]
    for other in (asyn, runs["file"]):
        assert {r.rid: r.generated for r in other.finished} == \
            {r.rid: r.generated for r in sync.finished}
        assert other.clock_s == sync.clock_s
        assert other.kv.disk_out_pages_total == sync.kv.disk_out_pages_total
    foot = asyn.trace.footer()
    assert foot["staged_issued_pages_total"] \
        == foot["staged_completed_pages_total"] > 0
    assert foot["staged_inflight_pages"] == 0 and asyn.prefetch_pages_total
    assert all(r.staged_issued_pages == r.staged_completed_pages
               for r in sync.trace.iterations)


def test_disk_engine_full_width_policy_reaches_the_disk(monkeypatch):
    """The scheduling of ``disk_engine``'s trace at the full width of
    qwen2.5-3b on the H100 preset, with the model's compute replaced by
    zero logits (no weights are built; only the 49-frame page pool): the
    shorts are admitted (their TPOT sits on the decode record's grid), L1
    is parked twice through the disk tier, every request meets its SLOs on
    the modeled clock, and the async run's staged prefetch moves the clock
    by less than the reference's 2% bound."""
    from repro_torch.launch import profile_engine as P
    from repro_torch.serving import engine as E

    class ZeroRuntime:
        def paged_decode_step(self, params, tokens, pos, pool, *tables):
            return torch.zeros((tokens.shape[0], 8)), pool

    monkeypatch.setattr(E.ServingEngine, "_rt",
                        lambda self: (ZeroRuntime(), None))
    monkeypatch.setattr(E.ServingEngine, "_bucketed_prefill",
                        lambda self, tokens, n: (torch.zeros((1, 8)), None,
                                                 None))
    monkeypatch.setattr(E.ServingEngine, "_scatter_prefill_kv",
                        lambda self, *a, **kw: None)
    clocks = {}
    for async_plane in (False, True):
        eng = P.disk_engine("cpu", async_plane=async_plane, params={})
        assert eng.kv.page_bytes == 589_824 and eng.interval == 6
        assert (eng.kv.device.total_pages, eng.kv.host.total_pages,
                eng.kv.disk.total_pages) == (4, 2, 16)
        first, later = P.disk_requests(eng, np.random.default_rng(0))
        assert all(r.tpot_slo_s == pytest.approx(0.016) for r in later)
        out = P.serve_disk_trace(eng, first, later)
        assert out["finished"] == 6 and out["slo_ok"]
        assert out["preemptions"] == 2 and out["disk_demotions"] > 0
        assert out["disk_stagings"] > 0 and eng.trace.audit().ok
        assert (out["prefetch_pages"] > 0) == async_plane
        clocks[async_plane] = eng.clock_s
    assert abs(clocks[True] - clocks[False]) <= 0.02 * clocks[False]
