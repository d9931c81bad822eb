"""Cross-framework lockstep: the reference ``ServingEngine`` (JAX) and the
port's engine (PyTorch, CPU), on bridged weights, serve one trace step by
step.

The policy layer is the same code in both packages, so every
``IterationRecord``, trace event, the modeled clock, the scheduler's
decisions and the per-link bytes must be *equal*; only the logits differ,
at bf16-rounding level. Greedy tokens follow the ``DualEngine`` rule
(``tests/differential/harness.py``: rtol 5e-2, atol 1e-1, ties counted and
bounded) and the port is teacher-forced with the reference's token, so a
numeric tie cannot fork the two trajectories.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.interval import NO_OFFLOAD, iter_time_with_interval_kv  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core.analyzer import PerformanceAnalyzer  # noqa: E402
from repro_torch.core.hardware import A10  # noqa: E402
from repro_torch.core.interval import OffloadPlan  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import pattern_info  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402

from _engine_builders import mk_reduced_engine  # noqa: E402

RTOL, ATOL = 5e-2, 1e-1          # DualEngine's logit tolerance
DIMS = dict(d_model=64, heads=2, layers=4, d_ff=128, vocab=128)
BATCHES, SEQS = (1, 2, 4), (16, 32, 64)


def mk_port_engine(jeng, *, extra_device_pages=None, hbm_gb=None,
                   page_size=16, **_):
    """The port's engine with the reference builder's sizing logic
    (``tests/_engine_builders.py``), the reference engine's config and its
    weights, bridged bit for bit."""
    cfg = reduce_config(get_config("qwen2.5-3b"), **DIMS)
    model = build_model(cfg)
    an = PerformanceAnalyzer(cfg, A10, measure="model")
    kv_tok = max(costs.kv_cache_bytes(cfg, 1, 1, model.virtual_kv), 1)
    page_bytes = page_size * kv_tok
    if extra_device_pages is not None:
        _, units = pattern_info(cfg)
        hbm = OffloadPlan(units, NO_OFFLOAD).device_bytes(
            costs.unit_weight_bytes(cfg)) + extra_device_pages * page_bytes
    else:
        hbm = hbm_gb * 1e9
    ecfg = EngineConfig(**dataclasses.asdict(jeng.ecfg))
    assert ecfg.hbm_budget_bytes == hbm
    slos = [0.002 * k for k in range(1, 30)]
    rec_p = an.generate_record(slos, list(BATCHES), list(SEQS), "prefill")
    rec_d = an.generate_record(slos, list(BATCHES), list(SEQS), "decode")
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), "cpu")
    return ServingEngine(jeng.name, model, A10, rec_p, rec_d, an.layer_times,
                         ecfg, device="cpu", params=params)


class Lockstep:
    """Steps both engines; checks equality of everything the policy layer
    produces and the DualEngine rule on every emitted token."""

    def __init__(self, jeng, teng):
        self.j, self.t = jeng, teng
        self.jreqs: dict[int, object] = {}
        self.expect: dict[int, list] = {}
        self.compares = self.ties = 0
        teng._greedy = self._forced_token

    def submit(self, jreq, treq) -> None:
        self.jreqs[jreq.rid] = jreq
        self.j.submit(jreq)
        self.t.submit(treq)

    def _forced_token(self, req, logits) -> int:
        want_logits, want_tok = self.expect[req.rid].pop(0)
        np.testing.assert_allclose(logits, want_logits, rtol=RTOL, atol=ATOL,
                                   err_msg=f"logits of rid {req.rid}")
        got_tok = int(np.argmax(logits))
        self.compares += 1
        if got_tok != want_tok:
            tie = ATOL + RTOL * abs(float(want_logits[want_tok]))
            assert (want_logits[want_tok] - want_logits[got_tok] <= tie
                    and logits[got_tok] - logits[want_tok] <= tie), \
                f"rid {req.rid}: token {got_tok} != {want_tok} beyond a tie"
            self.ties += 1
        return want_tok                      # teacher-forced

    def step(self) -> None:
        before = {rid: len(r.generated) for rid, r in self.jreqs.items()}
        self.j.step()
        grown = {rid for rid, r in self.jreqs.items()
                 if len(r.generated) > before[rid]}
        # the reference's emissions this step, per rid in emission order:
        # prefill / final-chunk logits, then the decode row of its slot
        self.expect = {rid: [] for rid in grown}
        for req, _slot, lg in self.j.prefill_log:
            self.expect[req.rid].append((lg, int(np.argmax(lg))))
        d = self.j.last_decode
        if d is not None:
            for slot in np.flatnonzero(d["active"]):
                rid = next(rid for rid in grown
                           if self.jreqs[rid].slot == slot)
                lg = d["logits"][slot]
                self.expect[rid].append((lg, int(np.argmax(lg))))
        for rid in grown:
            assert [t for _, t in self.expect[rid]] == \
                self.jreqs[rid].generated[before[rid]:]
        self.t.step()
        assert all(not q for q in self.expect.values()), \
            "the port emitted fewer tokens than the reference"
        jr = dataclasses.asdict(self.j.trace.iterations[-1])
        tr = dataclasses.asdict(self.t.trace.iterations[-1])
        assert tr == jr, f"iteration records differ at {jr['index']}"
        assert self.t.clock_s == self.j.clock_s
        jd, td = self.j.last_decode, self.t.last_decode
        assert (jd is None) == (td is None)
        if jd is not None:
            for key in ("tokens", "pos", "active"):
                assert np.array_equal(jd[key], td[key]), key

    def run(self, max_iters: int = 300) -> None:
        for _ in range(max_iters):
            if not (self.j.scheduler.has_work() or self.j._active_batch()):
                break
            self.step()
        for e in (self.j, self.t):
            assert not e.scheduler.has_work() and e._active_batch() == 0


def _burst(ls: Lockstep) -> int:
    """Submit the preemption burst: S0 and a long request whose cold prefix
    streams from host, then (two steps later) six short requests with a
    TPOT that affords one streamed page but not two."""
    eng = ls.j
    pb, iv = eng.kv.page_bytes, eng.interval
    dt_1 = iter_time_with_interval_kv(eng.times_fn(4, 48, "decode"), iv, pb)
    dt_2 = iter_time_with_interval_kv(eng.times_fn(1, 48, "decode"), iv,
                                      2 * pb)
    rng = np.random.default_rng(3)

    def req(rid, plen, new, tpot):
        kw = dict(rid=rid, prompt=rng.integers(0, 100, plen).astype(np.int32),
                  max_new_tokens=new, ttft_slo_s=10.0, tpot_slo_s=tpot)
        ls.submit(JRequest(**kw), TRequest(**kw))

    req(0, 4, 12, 1e-3)
    req(1, 16, 16, 1e-3)
    ls.step()
    ls.step()
    for rid in range(2, 8):
        req(rid, 4, 4, (dt_1 + dt_2) / 2)
    return 8


def _requests(n, plen, new, tpot=10.0, shared=0, seed=0):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 100, shared).astype(np.int32)
    out = []
    for i in range(n):
        p = np.concatenate([common, rng.integers(
            0, 100, plen[i % len(plen)] - shared).astype(np.int32)])
        t = tpot[i % len(tpot)] if isinstance(tpot, tuple) else tpot
        out.append(dict(rid=i, prompt=p, max_new_tokens=new[i % len(new)],
                        ttft_slo_s=10.0, tpot_slo_s=t))
    return out


CASES = {
    # device-only tier at a finite interval: offloaded weight units
    "device_only": dict(
        build=dict(extra_device_pages=12), interval=2,
        reqs=dict(n=5, plen=(5, 9, 14), new=(7, 4, 9))),
    # cold prefixes spill to the host tier and stream through the slab
    "host_tier": dict(
        build=dict(extra_device_pages=2.5, host_pages=24, page_size=8,
                   max_seq=32),
        reqs=dict(n=4, plen=(6, 12), new=(10, 6))),
    # head-of-line burst (tests/differential/test_preempt_resume.py): a
    # streaming long request blocks tight-TPOT shorts until it is parked
    "preemption": dict(
        build=dict(extra_device_pages=4, host_pages=64, page_size=8,
                   preemption=True), burst=True),
    "prefix_dedup": dict(
        build=dict(extra_device_pages=10, host_pages=8, page_size=8,
                   prefix_dedup=True),
        reqs=dict(n=4, plen=(20,), new=(6, 9), shared=12)),
    "autotune": dict(
        build=dict(extra_device_pages=8, host_pages=8, autotune=True),
        reqs=dict(n=5, plen=(8, 16), new=(5, 8), tpot=(0.002, 0.02))),
    "prefill_chunks": dict(
        build=dict(extra_device_pages=12, page_size=8,
                   prefill_chunk_tokens=8),
        reqs=dict(n=3, plen=(20, 7, 13), new=(5, 6))),
    # chunks through the paged chunk-prefill kernel, device tier only, at a
    # finite interval: prompts of 1-3 chunks, partial last pages (chunks of
    # 8 and 4 tokens only: the reference compiles once per chunk length)
    "incremental_prefill": dict(
        build=dict(extra_device_pages=12, page_size=8,
                   prefill_chunk_tokens=8, incremental_prefill=True),
        interval=2, reqs=dict(n=3, plen=(20, 12, 4), new=(5, 6))),
    # cold prefixes spill to the host tier: chunks stream host pages into
    # the slab and write the pages they fill back to the host pool
    "incremental_host_tier": dict(
        build=dict(extra_device_pages=2.5, host_pages=24, page_size=8,
                   max_seq=32, prefill_chunk_tokens=8,
                   incremental_prefill=True),
        reqs=dict(n=4, plen=(12, 20), new=(6, 4))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_lockstep(case):
    spec = CASES[case]
    build = dict(max_batch=4, max_seq=48, batches=BATCHES, seqs=SEQS, **DIMS)
    build.update(spec["build"])
    jeng, _ = mk_reduced_engine(name=case, **build)
    teng = mk_port_engine(jeng, **build)
    if "interval" in spec:
        assert jeng.set_interval(spec["interval"])
        assert teng.set_interval(spec["interval"])
    ls = Lockstep(jeng, teng)
    if spec.get("burst"):
        n = _burst(ls)
    else:
        n = spec["reqs"]["n"]
        for kw in _requests(**spec["reqs"]):
            ls.submit(JRequest(**kw), TRequest(**kw))
    ls.run()

    assert len(teng.finished) + len(teng.rejected) == n
    assert len(teng.finished) > 0
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    for jr, tr in zip(jeng.finished, teng.finished):
        assert tr.generated == jr.generated       # after teacher forcing
        assert tr.metrics() == jr.metrics()
    assert [dataclasses.asdict(e) for e in teng.trace.events] == \
        [dataclasses.asdict(e) for e in jeng.trace.events]
    assert teng.trace.totals() == jeng.trace.totals()
    assert teng._trace_footer() == jeng._trace_footer()
    assert teng.scheduler.stats == jeng.scheduler.stats
    report = teng.trace.audit()
    assert report.ok, report.violations
    assert ls.compares > 0 and ls.ties <= max(1, 0.05 * ls.compares)
    if case == "host_tier":
        assert teng.streamed_pages_peak > 0 and teng.host_kv_peak_pages > 0
    if case == "preemption":
        assert teng.scheduler.stats["preemptions"] > 0
    if case == "prefix_dedup":
        assert teng.kv.dedup_pages_reused > 0
    if case == "autotune":
        assert teng.interval_switches >= 1
    if case == "prefill_chunks":
        assert teng.scheduler.stats["chunked_prefill_iters"] > 0
    if case == "device_only":
        assert teng.interval == 2 and teng.kv.host.total_pages == 0
    if case.startswith("incremental"):
        # linear, not quadratic: every prompt token computed exactly once
        total = sum(len(r.prompt) for r in teng.finished)
        assert teng.prefill_tokens_computed == total
        assert jeng.prefill_tokens_computed == total
        assert teng.scheduler.stats["chunked_prefill_iters"] > 0
    if case == "incremental_prefill":
        assert teng.interval == 2 and teng.kv.host.total_pages == 0
    if case == "incremental_host_tier":
        assert teng.chunk_pages_streamed > 0
