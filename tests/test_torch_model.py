"""The port's model, runtime and cost model against the reference, on the
CPU, on weights bridged bit for bit from the reference's ``Model.init``.

Logits and block outputs agree at the bf16 tolerance the lockstep uses
(``DualEngine``: rtol 5e-2, atol 1e-1): weights and KV are bf16 on both
sides and the frameworks round bf16 at different places. The cost model's
byte counts are pure integer algebra and must be exactly equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core.interval import OffloadPlan as JPlan  # noqa: E402
from repro.core.memory_manager import OffloadRuntime as JRuntime  # noqa: E402
from repro.core.memory_manager import split_model_params as jsplit  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan  # noqa: E402
from repro_torch.core.memory_manager import (  # noqa: E402
    OffloadRuntime, merge_model_params, merge_stacked, split_model_params)
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import params_from_numpy, tree_leaves  # noqa: E402

RTOL, ATOL = 5e-2, 1e-1
DIMS = dict(d_model=64, heads=4, layers=4, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce(jget_config("qwen2.5-3b"), **DIMS)
    cfg = reduce_config(get_config("qwen2.5-3b"), **DIMS)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # non-zero biases, so the bias path is exercised too
    rng = np.random.default_rng(0)
    for key in ("bq", "bk", "bv"):
        a = jp["blocks"][0]["attn"][key]
        jp["blocks"][0]["attn"][key] = jnp.asarray(
            rng.standard_normal(a.shape, np.float32) * 0.1).astype(a.dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_bridged_weights_bitwise(models):
    jm, jp, tm, tp = models
    jl = jax.tree.leaves(jp)
    tl = tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.uint16).view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


def test_apply_block_seq(models):
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    b, s = 2, 24
    x = np.random.default_rng(1).standard_normal((b, s, cfg.d_model),
                                                 np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jctx = JT.SeqCtx(positions=jnp.asarray(pos), want_cache=True,
                     cache_len=s, virtual_kv=jm.virtual_kv)
    tctx = T.SeqCtx(positions=torch.from_numpy(pos.copy()), want_cache=True,
                    cache_len=s, virtual_kv=tm.virtual_kv)
    jblk = jax.tree.map(lambda a: a[1], jp["blocks"][0])
    tblk = T.unit_slice(tp["blocks"][0], 1)
    jy, jc, _ = jax.jit(lambda p, x: JT.apply_block_seq(
        jcfg, jcfg.pattern[0], p, x, jctx))(
        jblk, jnp.asarray(x).astype(jnp.bfloat16))
    ty, tc, _ = T.apply_block_seq(cfg, cfg.pattern[0], tblk,
                                  torch.from_numpy(x).to(torch.bfloat16), tctx)
    _close(ty, jy)
    for key in ("k", "v"):
        _close(tc["self"][key], jc["self"][key])
    assert np.array_equal(tc["self"]["pos"].numpy(),
                          np.asarray(jc["self"]["pos"]))


@pytest.mark.parametrize("window", [0, 24])
def test_attn_chunked_matches_reference_and_flash(models, window):
    """``attn_chunked``, the attention of the reference's prefill, kept in
    the port as a plain function: equal to the reference's at the fp32
    tolerance (1e-5), and to the flash kernel's plain version, which the
    port's prefill runs, at the bf16 tolerance (2e-2): the two scale q at
    different precisions in bf16 (ROADMAP Queue C)."""
    jm, _, tm, _ = models
    b, s, h, vh, hd = 2, 40, 4, 2, 16
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((b, s, n, hd), np.float32)
               for n in (h, vh, vh))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jax.jit(lambda q, k, v, p: JL.attn_chunked(
        jm.cfg, q, k, v, p, p, window=window, chunk=16))(q, k, v, pos)
    tp = torch.from_numpy(pos)
    got = L.attn_chunked(tm.cfg, *map(torch.from_numpy, (q, k, v)), tp, tp,
                         window=window, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    chunked = L.attn_chunked(tm.cfg, qb, kb, vb, tp, tp, window=window,
                             chunk=16)
    flash = flash_attention_plain(qb.transpose(1, 2), kb.transpose(1, 2),
                                  vb.transpose(1, 2), window=window)
    np.testing.assert_allclose(chunked.float().numpy(),
                               flash.transpose(1, 2).float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_apply_block_decode_paged(models):
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    rng = np.random.default_rng(2)
    b, page, frames, nb = 3, 8, 10, 3
    vh, hd = tm.virtual_kv, cfg.resolved_head_dim
    pool = rng.standard_normal((frames, page, cfg.num_layers, 2, vh, hd),
                               np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
    pos = np.array([5, 17, 0], np.int32)
    bt = np.array([[0, 1, 9], [2, 3, 4], [9, 9, 9]], np.int32)
    cl = np.array([6, 18, 0], np.int32)                # row 2 idle
    wf = np.array([0, 4, 9], np.int32)
    wo = np.array([5, 1, 0], np.int32)
    layer = 2
    jblk = jax.tree.map(lambda a: a[layer], jp["blocks"][0])
    tblk = T.unit_slice(tp["blocks"][0], layer)
    jx, jpool = jax.jit(lambda p, x, pool: JT.apply_block_decode_paged(
        jcfg, jcfg.pattern[0], p, x, jnp.asarray(pos), pool, layer,
        jnp.asarray(bt), jnp.asarray(cl), jnp.asarray(wf), jnp.asarray(wo),
        jm.virtual_kv, True))(
        jblk, jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(pool).astype(jnp.bfloat16))
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    tx, tpool2 = T.apply_block_decode_paged(
        cfg, cfg.pattern[0], tblk, torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(pos), tpool, layer, torch.from_numpy(bt),
        torch.from_numpy(cl), torch.from_numpy(wf).long(),
        torch.from_numpy(wo).long(), tm.virtual_kv)
    assert tpool2 is tpool                             # updated in place
    _close(tx[:2], jx[:2])
    _close(tpool, jpool)


def _chunk_inputs(cfg, vkv, c=12, start=13, page=8, nb=5, seed=7):
    """A chunk of ``c`` tokens at ``start`` over a shuffled block table whose
    last entry pads past the context with the null frame."""
    rng = np.random.default_rng(seed)
    frames = nb + 3
    pool = rng.standard_normal(
        (frames, page, cfg.num_layers, 2, vkv, cfg.resolved_head_dim),
        np.float32) * 0.5
    bt = rng.permutation(frames - 1)[:nb].astype(np.int32)
    end = start + c
    bt[-(-end // page):] = frames - 1
    toks = np.arange(start, end)
    wf = bt[toks // page]
    wo = (toks % page).astype(np.int32)
    x_toks = rng.integers(0, cfg.vocab_size, c).astype(np.int32)
    return x_toks, start, pool, bt, end, wf, wo


def test_apply_block_prefill_paged(models):
    jm, jp, tm, tp = models
    cfg, jcfg = tm.cfg, jm.cfg
    _, start, pool, bt, end, wf, wo = _chunk_inputs(cfg, tm.virtual_kv)
    c = end - start
    x = np.random.default_rng(8).standard_normal((1, c, cfg.d_model),
                                                 np.float32)
    layer = 1
    jblk = jax.tree.map(lambda a: a[layer], jp["blocks"][0])
    tblk = T.unit_slice(tp["blocks"][0], layer)
    posm = (start + np.arange(c, dtype=np.int32))[None]
    jx, jpool = jax.jit(lambda p, x, pool: JT.apply_block_prefill_paged(
        jcfg, jcfg.pattern[0], p, x, jnp.asarray(posm), pool, layer,
        jnp.asarray(bt), jnp.int32(end), jnp.asarray(wf), jnp.asarray(wo),
        jm.virtual_kv, True))(
        jblk, jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(pool).astype(jnp.bfloat16))
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    tx, tpool2 = T.apply_block_prefill_paged(
        cfg, cfg.pattern[0], tblk, torch.from_numpy(x).to(torch.bfloat16),
        start, tpool, layer, torch.from_numpy(bt), end,
        torch.from_numpy(wf).long(), torch.from_numpy(wo).long(),
        tm.virtual_kv)
    assert tpool2 is tpool                             # updated in place
    _close(tx, jx)
    _close(tpool, jpool)
    # the chunk's K/V landed where the table says, in this layer only
    before = torch.from_numpy(pool).to(torch.bfloat16)
    changed = (tpool != before).flatten(4).any(-1)     # [frames,page,L,2]
    assert changed[:, :, layer].sum() > 0
    assert not changed[:, :, :layer].any() and \
        not changed[:, :, layer + 1:].any()
    wrote = torch.zeros_like(changed[:, :, layer, 0])
    wrote[torch.from_numpy(wf).long(), torch.from_numpy(wo).long()] = True
    assert not (changed[:, :, layer].any(-1) & ~wrote).any()


@pytest.mark.parametrize("interval", [2, NO_OFFLOAD])
def test_runtime_paged_prefill_chunk_matches_reference(models, interval):
    """The runtime's chunk step against the reference's on the same pool:
    last-position logits and the whole pool at the DualEngine tolerance,
    and offloading leaves the port's chunk step bitwise unchanged."""
    jm, jp, tm, tp = models
    toks, start, pool, bt, end, wf, wo = _chunk_inputs(tm.cfg, tm.virtual_kv)
    _, r = JT.pattern_info(jm.cfg)
    jrt = JRuntime(model=jm, plan=JPlan(r, interval))
    jl, jpool = jax.jit(jrt.paged_prefill_chunk)(
        jsplit(jp, jrt.plan), jnp.asarray(toks), jnp.int32(start),
        jnp.asarray(pool).astype(jnp.bfloat16), jnp.asarray(bt),
        jnp.int32(end), jnp.asarray(wf), jnp.asarray(wo))
    out = {}
    for iv in {interval, NO_OFFLOAD}:
        trt = OffloadRuntime(tm, OffloadPlan(r, iv), device="cpu")
        tpool = torch.from_numpy(pool).to(torch.bfloat16)
        tl, tpool2 = trt.paged_prefill_chunk(
            trt.place(split_model_params(tp, trt.plan)),
            torch.from_numpy(toks), start, tpool, torch.from_numpy(bt), end,
            torch.from_numpy(wf), torch.from_numpy(wo))
        assert tpool2 is tpool
        out[iv] = (tl, tpool)
    tl, tpool = out[interval]
    assert tl.shape == (1, tm.cfg.padded_vocab())
    _close(tl, jl)
    _close(tpool, jpool)
    assert torch.equal(tl, out[NO_OFFLOAD][0])
    assert torch.equal(tpool, out[NO_OFFLOAD][1])


def test_prefill_and_decode_logits(models):
    jm, jp, tm, tp = models
    b, s, steps = 2, 10, 3
    toks = _tokens(b, s, tm.cfg.vocab_size)
    cache_len = s + steps
    jl, jc, _ = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, cache_len)
    tl, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len)
    _close(tl, jl)
    # shape-bucketed prefill: padded rows are causally inert
    pad = np.concatenate([toks, np.zeros((b, 6), np.int32)], axis=1)
    tl2, _, _ = tm.prefill(tp, {"tokens": torch.from_numpy(pad)},
                           cache_len + 6, last_pos=s - 1)
    assert torch.equal(tl2, tl)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    for i in range(steps):
        p = np.full((b,), s + i, np.int32)
        jl, jc = jdecode(jp, jnp.asarray(nxt), jnp.asarray(p), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt),
                                torch.from_numpy(p), tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def _paged_inputs(cfg, vkv, b=3, page=8, nb=3, seed=3):
    rng = np.random.default_rng(seed)
    frames = b * nb + 1
    pool = rng.standard_normal(
        (frames, page, cfg.num_layers, 2, vkv, cfg.resolved_head_dim),
        np.float32) * 0.5
    bt = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    pos = np.array([4, 13, 20], np.int32)[:b]
    cl = pos + 1
    wf = bt[np.arange(b), pos // page]
    wo = (pos % page).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    return toks, pos, pool, bt, cl, wf, wo


def _intervals(cfg):
    _, r = JT.pattern_info(cfg)
    return list(range(1, r + 1)) + [NO_OFFLOAD]


@pytest.fixture(scope="module")
def runtime_logits(models):
    """Reference and port logits of one paged decode step per interval."""
    jm, jp, tm, tp = models
    toks, pos, pool, bt, cl, wf, wo = _paged_inputs(tm.cfg, tm.virtual_kv)
    _, r = JT.pattern_info(jm.cfg)
    out = {}
    for iv in _intervals(jm.cfg):
        jrt = JRuntime(model=jm, plan=JPlan(r, iv))
        jl, _ = jax.jit(jrt.paged_decode_step)(
            jsplit(jp, jrt.plan), jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(pool).astype(jnp.bfloat16), jnp.asarray(bt),
            jnp.asarray(cl), jnp.asarray(wf), jnp.asarray(wo))
        trt = OffloadRuntime(tm, OffloadPlan(r, iv), device="cpu")
        tpool = torch.from_numpy(pool).to(torch.bfloat16)
        tl, _ = trt.paged_decode_step(
            trt.place(split_model_params(tp, trt.plan)),
            torch.from_numpy(toks), torch.from_numpy(pos), tpool,
            torch.from_numpy(bt), torch.from_numpy(cl), torch.from_numpy(wf),
            torch.from_numpy(wo))
        out[iv] = (jl, tl, tpool)
    return out


@pytest.mark.parametrize("interval", [1, 2, 3, 4, NO_OFFLOAD])
def test_runtime_paged_decode_matches_reference(runtime_logits, interval):
    jl, tl, tpool = runtime_logits[interval]
    _close(tl, jl)
    # offloading is a placement, never a math change: bitwise equal to the
    # all-resident step inside the port
    _, ref_l, ref_pool = runtime_logits[NO_OFFLOAD]
    assert torch.equal(tl, ref_l)
    assert torch.equal(tpool, ref_pool)


@pytest.mark.parametrize("interval", [1, 3, NO_OFFLOAD])
def test_runtime_prefill_matches_model(models, interval):
    jm, jp, tm, tp = models
    _, r = T.pattern_info(tm.cfg)
    plan = OffloadPlan(r, interval)
    rt = OffloadRuntime(tm, plan, device="cpu")
    toks = torch.from_numpy(_tokens(1, 16, tm.cfg.vocab_size, seed=4))
    got, caches, _ = rt.prefill(split_model_params(tp, plan),
                                {"tokens": toks}, 16, last_pos=11)
    want, wcaches, _ = tm.prefill(tp, {"tokens": toks}, 16, last_pos=11)
    assert torch.equal(got, want)
    merged = merge_stacked(caches, plan)
    for m, w in zip(merged, wcaches):
        for key in ("k", "v", "pos"):
            assert torch.equal(m["self"][key], w["self"][key])
    back = merge_model_params(split_model_params(tp, plan), plan)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def _attention_only(name):
    cfg = jget_config(name)
    return (cfg.encoder_layers == 0
            and all(b.mixer == "attention" for b in cfg.pattern))


ATTN_CONFIGS = [n for n in list_configs() if _attention_only(n)]


@pytest.mark.parametrize("name", ATTN_CONFIGS)
def test_costs_equal_reference(name):
    jcfg, cfg = jget_config(name), get_config(name)
    assert costs.unit_weight_bytes(cfg) == jcosts.unit_weight_bytes(jcfg)
    assert costs.layer_weight_bytes(cfg) == jcosts.layer_weight_bytes(jcfg)
    for b, s, vkv in ((1, 1, None), (8, 1024, None), (3, 777, 4)):
        assert costs.kv_cache_bytes(cfg, b, s, vkv) == \
            jcosts.kv_cache_bytes(jcfg, b, s, vkv)
        assert dataclasses.astuple(costs.iteration_cost(cfg, b, 1, s)) == \
            dataclasses.astuple(jcosts.iteration_cost(jcfg, b, 1, s))
    p = len(cfg.pattern)
    assert OffloadPlan(cfg.num_layers // p, 3).device_bytes(
        costs.unit_weight_bytes(cfg)) == JPlan(
        jcfg.num_layers // p, 3).device_bytes(jcosts.unit_weight_bytes(jcfg))
