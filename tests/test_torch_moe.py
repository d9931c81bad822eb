"""The port's ``apply_moe`` against the reference's, on the CPU, on the same
numpy inputs made from a seed.

Tolerances are ``tests/test_kernels.py``'s: fp32 1e-5, bf16 2e-2. Cases
cover the reduced dbrx and grok configs and dbrx's own routing (16
experts, top-4) at a small width, decode (S 1) and prefill lengths, a
router biased until experts drop tokens, and exact ties in the router's
probabilities (the reference's ``lax.top_k`` puts the lower expert id
first). The Switch aux loss must agree too. Also: the card's MoE engine
configuration and its TPOT SLO; with the ``cuda`` marker, ``apply_moe``
in bf16 against fp32 on the card and the MoE decode step's graph replay
against the eager step, bit for bit.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B = 2


def _configs(case: str):
    """(reference config, port config) of a case."""
    arch = "grok-1-314b" if case.startswith("grok") else "dbrx-132b"
    jcfg, cfg = jreduce(jget_config(arch)), reduce_config(get_config(arch))
    if case == "dbrx-routing":
        # dbrx's own routing at the reduced width
        jcfg = dataclasses.replace(jcfg, moe=JMoE(16, 4, 1.25))
        cfg = dataclasses.replace(cfg, moe=MoEConfig(16, 4, 1.25))
    return jcfg, cfg


def _params(cfg, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": rng.standard_normal((d, e), np.float32) / np.sqrt(d),
         "w1": rng.standard_normal((e, d, f), np.float32) / np.sqrt(d),
         "w2": rng.standard_normal((e, f, d), np.float32) / np.sqrt(f)}
    if cfg.gated_mlp:
        p["w3"] = rng.standard_normal((e, d, f), np.float32) / np.sqrt(d)
    return p


def _run(jcfg, cfg, params, x, dtype: str):
    """(reference y, aux), (port y, aux) as float32 numpy."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jy, jaux = jax.jit(lambda p, x: JL.apply_moe(jcfg, p, x))(
        {k: jnp.asarray(v).astype(jdt) for k, v in params.items()},
        jnp.asarray(x).astype(jdt))
    ty, taux = L.apply_moe(
        cfg, {k: torch.from_numpy(v).to(tdt) for k, v in params.items()},
        torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt and taux.dtype == torch.float32
    return ((np.asarray(jy.astype(jnp.float32)), float(jaux)),
            (ty.float().numpy(), float(taux)))


def _dropped(cfg, params, x) -> int:
    """Entries past their expert's capacity, counted from the router in
    float64 (the top-k of a biased router has no near ties)."""
    logits = np.einsum("bsd,de->bse", x.astype(np.float64), params["router"])
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    cap = L.moe_capacity(cfg, x.shape[1])
    counts = np.stack([(top == i).sum(axis=(1, 2)) for i in range(e)], -1)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("seq", [1, 7, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dbrx", "grok", "dbrx-routing"])
def test_apply_moe_matches_reference(case, dtype, seq):
    jcfg, cfg = _configs(case)
    params = _params(cfg)
    x = np.random.default_rng(1).standard_normal((B, seq, cfg.d_model),
                                                 np.float32)
    (jy, jaux), (ty, taux) = _run(jcfg, cfg, params, x, dtype)
    tol = TOL[dtype]
    assert ty.shape == (B, seq, cfg.d_model) and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    assert taux == pytest.approx(jaux, rel=tol, abs=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dbrx", "dbrx-routing"])
def test_apply_moe_drops_past_capacity(case, dtype):
    """A router biased toward the first experts overfills them: tokens are
    dropped into the trash row and contribute nothing, as in the
    reference. The bias keeps the router's logits near 5: at logits near
    100 the fp32 rounding of the router product alone, in either package,
    moves the renormalised weights by 1e-5."""
    jcfg, cfg = _configs(case)
    params = _params(cfg, seed=2)
    k = cfg.moe.top_k
    params["router"][:, :k] += 0.1
    x = np.abs(np.random.default_rng(3).standard_normal(
        (B, 32, cfg.d_model), np.float32))
    assert _dropped(cfg, params, x) > 0
    (jy, jaux), (ty, taux) = _run(jcfg, cfg, params, x, dtype)
    np.testing.assert_allclose(ty, jy, rtol=TOL[dtype], atol=TOL[dtype])
    assert taux == pytest.approx(jaux, rel=TOL[dtype], abs=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["dbrx", "dbrx-routing"])
def test_apply_moe_tie_order(case, dtype):
    """Exact ties in the router's probabilities: a zero router ties every
    expert, and duplicated router columns tie pairs. The top k takes the
    lower expert id first, as ``lax.top_k`` does; other choices would
    route through other experts' weights and miss the reference by far
    more than the tolerance."""
    jcfg, cfg = _configs(case)
    params = _params(cfg, seed=4)
    e = cfg.moe.num_experts
    x = np.random.default_rng(5).standard_normal((B, 9, cfg.d_model),
                                                 np.float32)
    zero = dict(params, router=np.zeros_like(params["router"]))
    pairs = dict(params)
    pairs["router"] = params["router"].copy()
    pairs["router"][:, e // 2:] = params["router"][:, :e - e // 2]
    for p in (zero, pairs):
        (jy, jaux), (ty, taux) = _run(jcfg, cfg, p, x, dtype)
        np.testing.assert_allclose(ty, jy, rtol=TOL[dtype], atol=TOL[dtype])
        assert taux == pytest.approx(jaux, rel=TOL[dtype], abs=TOL[dtype])
    # the all-tie router sends a decode token (cap 1: nothing dropped) to
    # experts 0..k-1 with equal weights: the mean of those experts' MLPs
    xt = torch.from_numpy(x[:, :1])
    tp = {key: torch.from_numpy(v).float() for key, v in zero.items()}
    y, _ = L.apply_moe(cfg, tp, xt)
    act = L._ACTS[cfg.act]
    want = sum((act(xt @ tp["w1"][i]) * (xt @ tp["w3"][i])) @ tp["w2"][i]
               for i in range(cfg.moe.top_k)) / cfg.moe.top_k
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_capacity_matches_reference():
    for case in ("dbrx", "grok", "dbrx-routing"):
        jcfg, cfg = _configs(case)
        for s in (1, 7, 64, 1024):
            assert L.moe_capacity(cfg, s) == JL.moe_capacity(jcfg, s)
    full, jfull = get_config("dbrx-132b"), jget_config("dbrx-132b")
    assert L.moe_capacity(full, 1) == JL.moe_capacity(jfull, 1) == 1
    assert L.moe_capacity(full, 1024) == JL.moe_capacity(jfull, 1024) == 320


def test_moe_engine_config_and_its_tpot_slo():
    """The card's MoE engine configuration (``profile_engine.moe_config``:
    dbrx-132b at full width, 4 layers) and its TPOT SLO on the datasheet
    ``h100`` clock in model mode (no weights are drawn; on the card the
    engine's clock takes the link of its own placement instead). At 4
    layers the two ring slots make interval 4 cost a unit more device
    memory than no offloading, so the budget sets no ceiling and the engine
    is held at 4 with 40 KV pages. Its TPOT SLO, 106 ms, is the smallest
    of the grid at which the decode record gives interval 4 for every
    bucket up to (8, 1024), the host tier streaming: the smallest feasible
    interval, a keeping-up tuner's choice (three resident units hide one
    6.52 GB copy at 64 GB/s: 104.2 ms). Interval 3 offloads the same unit
    but runs the tail unit after its copy, and misses it (106.1 ms)."""
    from repro_torch.core import costs
    from repro_torch.core.analyzer import PerformanceAnalyzer
    from repro_torch.core.hardware import H100
    from repro_torch.core.interval import (NO_OFFLOAD, OffloadPlan,
                                           iter_time_with_interval)
    from repro_torch.launch import profile_engine as P
    from repro_torch.models.transformer import pattern_info

    cfg, ecfg, interval = P.moe_config()
    assert interval == 4
    full = get_config("dbrx-132b")
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
    assert cfg.num_layers == 4 and (ecfg.max_batch, ecfg.max_seq) == (8, 1024)
    unit = costs.unit_weight_bytes(cfg)
    assert 6.5e9 < unit < 6.55e9
    _, units = pattern_info(cfg)
    plan = OffloadPlan(units, interval)
    assert plan.num_offloaded == 1
    assert plan.device_bytes(unit) > OffloadPlan(
        units, NO_OFFLOAD).device_bytes(unit)
    page_bytes = P.PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    assert ecfg.hbm_budget_bytes - plan.device_bytes(unit) == 40 * page_bytes
    an = PerformanceAnalyzer(cfg, H100, measure="model", device="cpu")
    batches, seqs = P.record_buckets(ecfg)
    rec = an.generate_record(P.SLO_GRID, batches, seqs, "decode")
    slo = P.measured_tpot_slo(rec, an.layer_times, cfg, ecfg,
                              interval=interval)
    assert slo == pytest.approx(0.106)
    assert all(rec.lookup(slo, b, s) == interval
               for b in batches if b <= 8 for s in seqs if s <= 1024)
    assert iter_time_with_interval(an.layer_times(8, 1024, "decode"),
                                   3) > slo


def test_moe_engine_models_its_fitted_terms():
    """The MoE engine's clock (Queue C 6 on this path): ``moe_hardware``
    fits the compute and HBM factors to dbrx's unit times and takes the
    placement's link, and ``moe_engine``'s records and clock run on that
    preset with the LM-head rest fitted apart: the clock's prefill and
    decode unit times at the calibration buckets are the times it was
    fitted to, its rest the one ``fit_rest`` was given, its transfer the
    link's (a reduced dbrx, placed on the CPU)."""
    from repro_torch.core import costs
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.launch import profile_engine as P
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info
    from repro_torch.serving.engine import EngineConfig, place_weights

    cfg = reduce_config(get_config("dbrx-132b"), layers=4)
    units = {"prefill": {"mean_s": 3e-3}, "decode": {"mean_s": 1e-3},
             "rest": {"s": 2e-4, "mem_eff": P.fit_rest(cfg, 2e-4)}}
    link = {"host_link_bw": 40e9, "host_link_latency_s": 2e-5}
    hw = P.moe_hardware(cfg, units, link)
    assert (hw.host_link_bw, hw.host_link_latency_s) == (40e9, 2e-5)
    _, n = pattern_info(cfg)
    page_bytes = P.PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    ecfg = EngineConfig(max_batch=8, max_seq=P.MAX_SEQ,
                        page_size=P.PAGE_SIZE,
                        hbm_budget_bytes=OffloadPlan(n, n).device_bytes(
                            costs.unit_weight_bytes(cfg)) + 8 * page_bytes)
    params = P.engine_weights(cfg, "cpu")
    rt, placed = place_weights(build_model(cfg), params, OffloadPlan(n, n),
                               "cpu")
    eng = P.moe_engine(cfg, ecfg, {"params": params, "runtime": rt,
                                   "placed": placed}, hw,
                       units["rest"]["mem_eff"], device="cpu")
    assert eng.hw is hw and eng._rt()[0] is rt
    for phase, want in (("prefill", 3e-3), ("decode", 1e-3)):
        b, s = P.CALIBRATION_BUCKETS[phase]
        t = eng.times_fn(b, s, phase)
        assert t.t_compute_s == pytest.approx(want)
        assert t.t_transfer_s == pytest.approx(
            2e-5 + costs.unit_weight_bytes(cfg) / 40e9)
    assert eng.times_fn(8, P.MAX_SEQ, "decode").t_rest_s == pytest.approx(
        2e-4, rel=1e-2)


@pytest.mark.parametrize("layers", [2, 4])
def test_moe_config_streams_one_unit_at_any_depth(layers):
    """``moe_config`` holds the interval of one group at every depth, the
    2-layer cut included: one unit streams each step, the engine pins one
    unit's bytes, and its budget is that plan's device bytes plus 40 KV
    pages, whose interval ceiling reaches the held interval (the engine
    can switch to it)."""
    from repro_torch.core import costs
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.launch import profile_engine as P
    from repro_torch.models.transformer import pattern_info

    cfg, ecfg, interval = P.moe_config(layers)
    _, units = pattern_info(cfg)
    assert cfg.num_layers == units == interval == layers
    plan = OffloadPlan(units, interval)
    assert plan.enabled and plan.num_offloaded == 1
    assert plan.offloaded_indices() == [layers - 1]
    unit = costs.unit_weight_bytes(cfg)
    assert plan.host_bytes(unit) == unit
    page_bytes = P.PAGE_SIZE * costs.kv_cache_bytes(cfg, 1, 1)
    assert ecfg.hbm_budget_bytes - plan.device_bytes(unit) == 40 * page_bytes
    assert P.memory_interval(cfg, ecfg) >= interval


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE runs on the card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_cfg():
    """dbrx-132b's routing (16 experts, top-4) and group size (48 heads
    over 8 KV heads, as 12 over 2) at a small width."""
    cfg = reduce_config(get_config("dbrx-132b"), d_model=384, heads=12,
                        layers=4, d_ff=512, vocab=1024)
    return dataclasses.replace(cfg, moe=MoEConfig(16, 4, 1.25))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 1), (1, 256)], ids=["decode", "prefill"])
def test_apply_moe_on_card_matches_fp32(cuda, b, s):
    """bf16 on the card against the same weights and input in fp32 on the
    card (no TF32): relative L2 at most 0.02. The router runs in fp32 from
    the same bf16 values either way, so both route alike."""
    cfg = reduce_config(get_config("dbrx-132b"), d_model=1024, d_ff=2048)
    cfg = dataclasses.replace(cfg, moe=MoEConfig(16, 4, 1.25))
    params = {k: torch.from_numpy(v).to(cuda).to(torch.bfloat16)
              for k, v in _params(cfg, seed=6).items()}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, s, cfg.d_model), np.float32)).to(cuda).to(torch.bfloat16)
    got, aux = L.apply_moe(cfg, params, x)
    want, want_aux = L.apply_moe(
        cfg, {k: v.float() for k, v in params.items()}, x.float())
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 0.02, rel
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    cpu, _ = L.apply_moe(cfg, {k: v.cpu() for k, v in params.items()},
                         x.cpu())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               cpu.float().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 3])
def test_moe_decode_step_replay_is_bitwise_eager(cuda, interval):
    """The MoE decode step (sort, searchsorted, gathers and expert GEMMs,
    no host sync) captures into a CUDA graph, and its replay gives the
    eager step's bits: logits and every pool page, over two steps with new
    inputs copied into the graph's static buffers."""
    import functools

    from repro_torch.core import graphs
    from repro_torch.core.analyzer import decode_pool, paged_decode_inputs
    from repro_torch.core.interval import OffloadPlan
    from repro_torch.core.memory_manager import (OffloadRuntime,
                                                 split_model_params)
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import pattern_info

    cfg = _card_cfg()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    _, units = pattern_info(cfg)
    rt = OffloadRuntime(model, OffloadPlan(units, interval), cuda)
    step = functools.partial(rt.paged_decode_step,
                             rt.place(split_model_params(params, rt.plan)))
    gen = torch.Generator(cuda).manual_seed(1)
    pool = decode_pool(cfg, model.virtual_kv, 8, 64, cuda)
    pool.copy_(torch.randn(pool.shape, generator=gen, device=cuda))
    d = paged_decode_inputs(pool, 8, 64)
    tokens = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                           device=cuda, dtype=torch.int32)
    eager_in = [tokens, d.pos, pool, d.block_tables, d.context_lens,
                d.write_frames, d.write_offsets]
    graph_in = [t.clone() for t in eager_in]
    g = graphs.Graphed(step, graph_in, [(rt._stream, "copies")])
    for k in range(2):
        if k:
            for inp in (eager_in, graph_in):
                inp[0].copy_((inp[0] * 7 + 3) % cfg.vocab_size)
        want, _ = step(*eager_in)
        got, _ = g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
        assert torch.equal(graph_in[2], eager_in[2]), k
