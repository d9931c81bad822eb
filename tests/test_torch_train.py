"""The port's training path against the reference, on the CPU: the flash
backward's plain version, the loss, the gradients, the AdamW train step,
remat, microbatches, the token stream and the train CLI. The ``cuda``
tests hold the backward kernels against their plain version on the card
and run one train step there; they skip without a GPU.

Tolerances, each with its reason:
- fp32 1e-5: the plain backward against autograd through dense attention
  (the same function, summed in another order);
- bf16 2e-2 (``tests/test_kernels.py``): anything that goes through bf16
  inputs or weights on either side;
- loss rtol 2e-2 and per-leaf relative L2 0.02: bf16 weights and
  activations, rounded at different places by the two frameworks;
- a parameter's change under AdamW by relative L2, each bound set between
  the readings of sound runs and of a port with its update broken (no
  update, no bias correction, the weight decay's sign flipped, microbatch
  gradients not divided, dropped or summed in bf16), both stated at the
  test.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train.py
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train.py
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticTokenStream as JStream  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_loop import build_train_step as jbuild_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import (params_from_numpy, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             build_train_step,
                                             init_train_state)

BF16 = dict(rtol=2e-2, atol=2e-2)
REL_L2 = 0.02
SHAPE = ShapeSpec("tiny", 16, 2, "train")
JSHAPE = JShape("tiny", 16, 2, "train")


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates its tensors in place."""
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# The flash backward
# ---------------------------------------------------------------------------

# (b, h, vh, sq, sk, d, keywords): causal and not, g 1 / 2 / 4, window,
# ragged lengths, kv_len and pos_offset, head_dim 16 to 256
BWD_CASES = {
    "causal_g2": (2, 4, 2, 70, 70, 16, {}),
    "causal_g1_window": (1, 2, 2, 100, 100, 16, {"window": 20}),
    "noncausal_g4_kv_len": (1, 4, 1, 50, 130, 32, {"causal": False,
                                                   "kv_len": 100}),
    "ragged_g4": (1, 8, 2, 33, 100, 16, {}),
    "pos_offset": (1, 4, 2, 40, 90, 16, {"pos_offset": 10}),
    "d256_g2": (1, 2, 1, 40, 40, 256, {}),
}


def _dense(q, k, v, causal=True, window=0, kv_len=None, pos_offset=0):
    """Softmax attention in one dense product, differentiated by autograd."""
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    kk, vv = k.repeat_interleave(h // vh, 1), v.repeat_interleave(h // vh, 1)
    kv_len = sk if kv_len is None else kv_len
    qpos = FA._offset(sq, kv_len, causal, pos_offset) + torch.arange(sq)
    valid = FA._visible(0, sk, qpos, kv_len, causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / math.sqrt(d)
    s = s.masked_fill(~valid, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vv)


def _qkv(b, h, vh, sq, sk, d, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        dtype).requires_grad_(True)
    return mk(b, h, sq, d), mk(b, vh, sk, d), mk(b, vh, sk, d), \
        torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32))


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_autograd(case):
    b, h, vh, sq, sk, d, kw = BWD_CASES[case]
    q, k, v, do = _qkv(b, h, vh, sq, sk, d)
    out = FA.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(_dense(q, k, v, **kw), (q, k, v), do)
    torch.testing.assert_close(out, _dense(q, k, v, **kw), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"window": 2}, {"causal": False,
                                                    "kv_len": 4}])
def test_flash_gradcheck_fp64(kw):
    # tiny: gradcheck differentiates numerically element by element
    q, k, v, _ = _qkv(1, 2, 1, 5, 6, 8, seed=1, dtype=torch.float64)
    fn = lambda q, k, v: FA.FlashAttention.apply(
        q, k, v, kw.get("causal", True), kw.get("window", 0),
        kw.get("kv_len"), 0)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def _jax_attn_grads(q, k, v, do, causal, window, kv_len, pos_offset):
    """jax.grad of the reference's ``attn_chunked`` ([B,S,H,D] layout;
    non-causal is its cross mode; keys past kv_len get position -1, and
    the queries the positions the kernel gives them)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    kpos = np.where(np.arange(sk) < kv_len, np.arange(sk), -1)
    k_pos = jnp.asarray(np.broadcast_to(kpos, (b, sk)).astype(np.int32))
    q_pos = jnp.asarray(np.broadcast_to(
        FA._offset(sq, kv_len, causal, pos_offset) + np.arange(sq),
        (b, sq)).astype(np.int32))
    cfg = jreduce(jget_config("qwen2.5-3b"))

    def f(q, k, v):
        o = JL.attn_chunked(cfg, q, k, v, q_pos, k_pos, window=window,
                            cross=not causal, chunk=64)
        return jnp.sum(o.astype(jnp.float32) * do)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_matches_jax_grad_of_attn_chunked(case):
    b, h, vh, sq, sk, d, kw = BWD_CASES[case]
    q, k, v, do = _qkv(b, h, vh, sq, sk, d, seed=3, dtype=torch.bfloat16)
    out = FA.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do.to(torch.bfloat16))
    bshd = lambda t: jnp.asarray(_np(t).transpose(0, 2, 1, 3)).astype(
        jnp.bfloat16)
    want = _jax_attn_grads(bshd(q), bshd(k), bshd(v),
                           jnp.asarray(do.numpy().transpose(0, 2, 1, 3)),
                           kw.get("causal", True), kw.get("window", 0),
                           kw.get("kv_len"), kw.get("pos_offset", 0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32)
                                   .transpose(0, 2, 1, 3), **BF16)


def test_flash_attention_differentiable_only_when_asked():
    q, k, v, _ = _qkv(1, 2, 1, 8, 8, 16)
    assert FA.flash_attention(q, k, v).grad_fn is not None
    with torch.no_grad():
        assert FA.flash_attention(q, k, v).grad_fn is None
    plain = [t.detach() for t in (q, k, v)]
    assert FA.flash_attention(*plain).grad_fn is None
    torch.testing.assert_close(FA.flash_attention(q, k, v).detach(),
                               FA.flash_attention_plain(*plain), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# Model, loss and train step against the reference (bridged weights)
# ---------------------------------------------------------------------------

# deepseek's and qwen's families, and gemma's (head_dim 256, MQA, GeGLU,
# tied embeddings) as gemma-2b and as paligemma-3b's text backbone
ARCHS = ("deepseek-7b", "qwen2.5-3b", "gemma-2b", "paligemma-3b")


def _cfgs(arch):
    return (jreduce(jget_config(arch), layers=2),
            reduce_config(get_config(arch), layers=2))


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg, cfg = _cfgs(request.param)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = JStream(jcfg, JSHAPE, JData(seed=1)).batch(0)
    tb = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1), device="cpu") \
        .batch(0)
    return jm, jp, jb, tm, tp, tb


@pytest.fixture(scope="module")
def reference_grads(bridged):
    jm, jp, jb, *_ = bridged
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=True), has_aux=True))(jp)
    return float(loss), g


def test_loss_fn_matches_reference(bridged, reference_grads):
    *_, tm, tp, tb = bridged
    loss, parts = tm.loss_fn(tp, tb, remat=True)
    np.testing.assert_allclose(float(loss), reference_grads[0], rtol=2e-2)
    assert float(parts["aux"]) == 0.0


def _port_grads(tm, tp, tb, remat=True):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    it = iter(leaves)
    loss, _ = tm.loss_fn(tree_map(lambda _: next(it), tp), tb, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_grads_match_jax_grad(bridged, reference_grads):
    """bf16 weights: the whole gradient within relative L2 0.02. (Per leaf,
    bf16 rounding alone reaches 0.0200 on qwen's key bias with plain dense
    attention on both sides; the per-leaf check is the fp32 one below.)"""
    *_, tm, tp, tb = bridged
    _, got = _port_grads(tm, tp, tb)
    want = jax.tree.leaves(jax.tree.map(np.asarray, reference_grads[1]))
    assert len(got) == len(want)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    flat = lambda xs: np.concatenate([np.asarray(x, np.float32).ravel()
                                      for x in xs])
    assert _rel_l2(flat(_np(g) for g in got), flat(want)) <= REL_L2


def test_grads_match_jax_grad_per_leaf_fp32(bridged):
    """The same weights in fp32 on both sides, where the point is the
    algorithm (flash backward, remat, loss): every leaf within 1e-5."""
    jm, jp, jb, tm, tp, tb = bridged
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp32 = tree_map(lambda t: t.float(), tp)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=True), has_aux=True))(jp32)
    loss, got = _port_grads(tm, tp32, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(got, jax.tree.leaves(jg)):
        assert _rel_l2(_np(g), np.asarray(w)) <= 1e-5


def _changes(params, start):
    """Each leaf's change from ``start`` (fp32 numpy arrays), as numpy."""
    return [_np(t) - z for t, z in zip(params, start)]


def _jchanges(params, start):
    return [np.asarray(w, np.float32) - z for w, z in zip(
        jax.tree.leaves(jax.tree.map(np.asarray, params)), start)]


# AdamW's update held against the reference's on the same parameters and
# gradients (below): each leaf's change after each step by relative L2.
# Readings: 0 in bf16, up to 1.9e-6 in fp32; controls in the port: no
# update 1.0, no bias correction 0.59-0.94, the weight decay's sign flipped
# 0.23-0.56. The moments within 1e-5 (readings up to 4.5e-7).
ADAMW_REL_L2 = 1e-3


@pytest.mark.parametrize("dtype,clip", [("bfloat16", 1.0), ("float32", 1.0),
                                        ("bfloat16", 1e9)])
def test_adamw_update_matches_reference(dtype, clip):
    """Three AdamW steps on the same parameters and gradients in both
    packages (gradients new each step, some elements near zero, the clip
    active or not; warmup 2 then cosine): the parameters' changes per leaf,
    both moments, ``grad_norm``, ``lr`` and ``count``."""
    rng = np.random.default_rng(11)
    shapes = [(64, 32), (32,), (3, 16, 8), (1,)]
    start = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    start[1] += 1.0                              # a norm scale
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # copies throughout: the port updates in place, and numpy, jax and
    # torch arrays on the CPU may share one buffer
    jp = [jnp.array(x).astype(jdt) for x in start]
    tp = [torch.tensor(x).to(tdt) for x in start]
    start = [np.array(x, np.float32) for x in jp]
    jopt, topt = JO.init_opt_state(jp), O.init_opt_state(tp)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32)
                 * rng.choice([1e-6, 1e-2, 1.0], s) for s in shapes]
        jp, jopt, jm_ = JO.adamw_update(JO.AdamWConfig(**cfg), jp,
                                        [jnp.array(g) for g in grads], jopt)
        tp, topt, tm_ = O.adamw_update(O.AdamWConfig(**cfg), tp,
                                       [torch.tensor(g) for g in grads],
                                       topt)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-6)
        for got, want in zip(_changes(tp, start), _jchanges(jp, start)):
            assert _rel_l2(got, want) <= ADAMW_REL_L2
        for key in ("m", "v"):
            for got, want in zip(topt[key], jopt[key]):
                assert _rel_l2(_np(got), np.asarray(want)) <= 1e-5
    assert all(t.dtype == tdt for t in tp)
    assert int(topt["count"]) == int(jopt["count"]) == 3


# The train step's change to the parameters against the reference's, over
# the whole tree in bf16 and per leaf in fp32 (readings at each test):
# bf16's elementwise noise flips the sign of Adam's first steps on
# near-zero gradients, so per leaf only fp32 separates a sound update from
# a wrong one.
STEP_CHANGE_REL_L2 = {"bf16": 0.25, "fp32": 0.02}


def test_three_train_steps_in_lockstep(bridged):
    """bf16, the CLI's learning rate: loss, ``grad_norm``, ``lr`` and the
    parameters after each step at bf16 tolerance, and the whole tree's
    change within relative L2 0.25. Readings up to 0.123; controls in the
    port: the weight decay's sign flipped 0.40, no bias correction 0.71, no
    update 1.0. (Adam moves a weight by about lr whatever its gradient's
    size, so a near-zero gradient whose sign the two frameworks round apart
    moves it 2 lr apart per step.)"""
    jm, jp, jb, tm, tp, tb = bridged
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(jbuild_step(jm, JTrainConfig(
        optimizer=JO.AdamWConfig(**ocfg))))
    tstep = build_train_step(tm, TrainConfig(optimizer=O.AdamWConfig(**ocfg)))
    jopt = JO.init_opt_state(jp)
    tp = tree_map(torch.clone, tp)
    topt = O.init_opt_state(tp)
    start = [_np(t) for t in tree_leaves(tp)]
    flat = lambda xs: np.concatenate([x.ravel() for x in xs])
    for _ in range(3):
        jp, jopt, jm_ = jstep(jp, jopt, jb)
        tp, topt, tm_ = tstep(tp, topt, tb)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=2e-2)
        for g, w in zip(tree_leaves(tp),
                        jax.tree.leaves(jax.tree.map(np.asarray, jp))):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       **BF16)
        assert _rel_l2(flat(_changes(tree_leaves(tp), start)),
                       flat(_jchanges(jp, start))) <= STEP_CHANGE_REL_L2["bf16"]
    assert int(topt["count"]) == int(jopt["count"]) == 3


def test_three_train_steps_in_lockstep_fp32(bridged):
    """The same weights in fp32 on both sides at lr 1e-2: loss and
    ``grad_norm`` at 1e-4 and every leaf's change per step within relative
    L2 0.02. Readings up to 0.0053 (qwen's key bias); controls in the
    port: the weight decay's sign flipped 0.199, no bias correction
    0.55-0.58, no update 1.0."""
    jm, jp, jb, tm, tp, tb = bridged
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp = tree_map(lambda t: t.float(), tp)
    ocfg = dict(lr=1e-2, warmup_steps=1)
    jstep = jax.jit(jbuild_step(jm, JTrainConfig(
        optimizer=JO.AdamWConfig(**ocfg))))
    tstep = build_train_step(tm, TrainConfig(optimizer=O.AdamWConfig(**ocfg)))
    jopt, topt = JO.init_opt_state(jp), O.init_opt_state(tp)
    start = [_np(t) for t in tree_leaves(tp)]
    for _ in range(3):
        jp, jopt, jm_ = jstep(jp, jopt, jb)
        tp, topt, tm_ = tstep(tp, topt, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-4)
        for got, want in zip(_changes(tree_leaves(tp), start),
                             _jchanges(jp, start)):
            assert _rel_l2(got, want) <= STEP_CHANGE_REL_L2["fp32"]


def test_remat_is_bitwise_on_cpu(bridged):
    *_, tm, tp, tb = bridged
    (l1, g1), (l2, g2) = (_port_grads(tm, tp, tb, remat=r)
                          for r in (True, False))
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_microbatch_accumulation_matches_big_batch(bridged):
    """Microbatches 2 against 1 from the same weights, one step at lr 1e-2:
    in bf16, loss and ``grad_norm`` at rtol 2e-2 (a missing division by
    the count reads 2.0, a dropped microbatch 0.68-0.74), the parameters
    at bf16 tolerance and each leaf's change within relative L2 0.1
    (readings 0.028-0.033; a dropped microbatch 0.97-1.04); in fp32, each
    leaf's change against the reference's microbatched step within 1e-2
    (readings up to 0.0016; accumulating in bf16 reads 0.029-0.035)."""
    jm, jp, jb, tm, tp, tb = bridged
    ocfg = O.AdamWConfig(lr=1e-2, warmup_steps=1)
    split = lambda b, lib: {k: lib.asarray(v).reshape(2, 1, *v.shape[1:])
                            for k, v in b.items()}
    outs = []
    for n, batch in ((2, split(tb, torch)), (1, tb)):
        params = tree_map(torch.clone, tp)
        step = build_train_step(tm, TrainConfig(optimizer=ocfg,
                                                microbatches=n))
        outs.append(step(params, O.init_opt_state(params), batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(outs[0][2][key]),
                                   float(outs[1][2][key]), rtol=2e-2)
    start = [_np(t) for t in tree_leaves(tp)]
    for a, b, z in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0]),
                       start):
        np.testing.assert_allclose(_np(a), _np(b), **BF16)
        assert _rel_l2(_np(a) - z, _np(b) - z) <= 0.1
    # fp32 on both sides against the reference's scan over microbatches
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp = tree_map(lambda t: t.float(), tp)
    start = [_np(t) for t in tree_leaves(tp)]
    jcfg = JTrainConfig(optimizer=JO.AdamWConfig(lr=1e-2, warmup_steps=1),
                        microbatches=2)
    jp2, _, jm_ = jax.jit(jbuild_step(jm, jcfg))(jp, JO.init_opt_state(jp),
                                                  split(jb, jnp))
    step = build_train_step(tm, TrainConfig(optimizer=ocfg, microbatches=2))
    tp2, _, tm_ = step(tp, O.init_opt_state(tp), split(tb, torch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   rtol=1e-4)
    for got, want in zip(_changes(tree_leaves(tp2), start),
                         _jchanges(jp2, start)):
        assert _rel_l2(got, want) <= 1e-2


def test_loss_decreases_overfitting_one_batch():
    cfg = reduce_config(get_config("deepseek-7b"), layers=2)
    model = build_model(cfg)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0),
                                   "cpu")
    step = build_train_step(model, TrainConfig(
        optimizer=O.AdamWConfig(lr=1e-2, warmup_steps=1), remat=True))
    batch = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1),
                                 device="cpu").batch(0)
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("step", [0, 1, 2, 99, 150, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    got = O.lr_at(O.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    want = JO.lr_at(JO.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_xent_losses_match_reference():
    jcfg, cfg = _cfgs("qwen2.5-3b")
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 9, 40), np.float32)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = T.xent_loss(cfg, torch.from_numpy(logits),
                          torch.from_numpy(labels),
                          None if m is None else torch.from_numpy(m))
        want = JT.xent_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the chunked form from hidden states, chunks ragged against S
    d, v = 16, 40
    hidden = rng.standard_normal((2, 9, d), np.float32)
    embed = rng.standard_normal((v, d), np.float32) * 0.3
    jp = {"embed": jnp.asarray(embed).astype(jnp.bfloat16)}
    tp = {"embed": torch.from_numpy(embed).to(torch.bfloat16)}
    jh = jnp.asarray(hidden).astype(jnp.bfloat16)
    th = torch.from_numpy(hidden).to(torch.bfloat16)
    got = T.xent_loss_chunked(cfg, tp, th, torch.from_numpy(labels), chunk=4)
    want = JT.xent_loss_chunked(jcfg, jp, jh, jnp.asarray(labels), chunk=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_opt_state_carries_across_the_bridge(bridged):
    jm, jp, jb, tm, tp, tb = bridged
    jopt = JO.init_opt_state(jp)
    jopt = {"m": jax.tree.map(lambda x: x + 0.25, jopt["m"]),
            "v": jopt["v"], "count": jnp.asarray(7, jnp.int32)}
    topt = params_from_numpy(jax.tree.map(np.asarray, jopt), "cpu")
    assert topt["count"].dtype == torch.int32 and topt["count"].shape == ()
    assert int(topt["count"]) == 7
    for g, w in zip(tree_leaves(topt["m"]), jax.tree.leaves(jopt["m"])):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Token stream and CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "paligemma-3b",
                                  "seamless-m4t-medium"])
def test_token_stream_bitwise_equal_to_reference(arch):
    jcfg, cfg = jreduce(jget_config(arch)), reduce_config(get_config(arch))
    shape, jshape = ShapeSpec("t", 24, 3, "train"), JShape("t", 24, 3, "train")
    mine = SyntheticTokenStream(cfg, shape, DataConfig(seed=4), device="cpu")
    ref = JStream(jcfg, jshape, JData(seed=4))
    for step in (0, 5):
        got, want = mine.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for key in got:
            w = np.asarray(want[key])
            assert got[key].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[key].numpy(), w)
    # on a 1x1 mesh every leaf is a DTensor split by rows over "data",
    # whole on "model", float leaves in bf16 as the reference's mesh path
    # makes them; its rows are the same batch
    from repro_torch.launch import mesh as M
    from torch.distributed.tensor import DTensor, Replicate, Shard

    M.destroy()
    try:
        mesh = M.make_mesh_compat((1, 1), ("data", "model"), "cpu")
        placed = SyntheticTokenStream(cfg, shape, DataConfig(seed=4),
                                      mesh).batch(5)
        for key, t in placed.items():
            assert isinstance(t, DTensor)
            assert tuple(t.placements) == (Shard(0), Replicate())
            full = t.full_tensor()
            if full.is_floating_point():
                assert full.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    full.float().numpy(),
                    got[key].bfloat16().float().numpy())
            else:
                assert torch.equal(full, got[key])
    finally:
        M.destroy()


def test_train_cli_loss_falls_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--lr", "1e-2", "--ckpt-dir", ck, "--ckpt-every", "3"]
    first = train.main(base + ["--steps", "6"])
    assert np.isfinite(first["losses"]).all()
    assert min(first["losses"][3:]) < first["losses"][0]
    resumed = train.main(base + ["--steps", "8", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "device cpu" in out
    assert len(resumed["losses"]) == 2 and np.isfinite(resumed["losses"]).all()
    # --mesh 2x1 runs in one process on the fake backend (rank 0's local
    # numbers), and is refused on a real one, whose world is one rank
    fake = train.main(["--device", "cpu", "--reduced", "--mesh", "2x1",
                       "--backend", "fake", "--batch", "2", "--seq", "16",
                       "--steps", "2"])
    assert len(fake["losses"]) == 2 and np.isfinite(fake["losses"]).all()
    assert "mesh 2x1 on fake" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--reduced", "--mesh", "2x1"])
    assert "needs 2 processes" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# qwen's and gemma's training shapes; windows, ragged and non-causal
# lengths, kv_len, pos_offset; every head dim. The dK/dV pass cuts each
# 64-key tile's (head, query tile) items into units, several per group at
# qwen's and gemma's shapes and in "g16_units"; at g 1 ("g1_d64",
# "g1_window") the units split the query range
CUDA_BWD_CASES = {
    "qwen_causal": (2, 16, 2, 1024, 1024, 128, {}),
    "gemma_d256": (2, 8, 1, 1024, 1024, 256, {}),
    "d256_window": (1, 8, 1, 300, 300, 256, {"window": 100}),
    "d256_ragged_noncausal": (1, 4, 1, 77, 201, 256, {"causal": False,
                                                      "kv_len": 150}),
    "g16_units": (1, 16, 1, 512, 512, 64, {}),
    "g1_window": (1, 2, 2, 1024, 1024, 128, {"window": 300}),
    "window": (1, 8, 2, 300, 300, 128, {"window": 100}),
    "ragged_noncausal": (1, 8, 2, 77, 201, 64, {"causal": False,
                                                "kv_len": 150}),
    "g1_d64": (1, 4, 4, 130, 130, 64, {}),
    "g8_d32": (2, 8, 1, 96, 160, 32, {}),
    "d16_pos_offset": (1, 4, 2, 70, 100, 16, {"pos_offset": -10}),
}


def _cuda_inputs(dev, b, h, vh, sq, sk, d, seed=0):
    """Strided [B,S,heads,D] projections viewed as [B,heads,S,D], as the
    model passes them, and a dO of the output's layout."""
    gen = torch.Generator(dev).manual_seed(seed)
    mk = lambda s, n: torch.randn((b, s, n, d), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    return mk(sq, h), mk(sk, vh), mk(sk, vh), mk(sq, h)


def _fwd_with_lse(q, k, v, **kw):
    """The forward kernel's output and the log-sum-exp it writes."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    kw = {"causal": True, "window": 0, "kv_len": None, "pos_offset": 0, **kw}
    return FA._flash_fwd_cuda(q, k, v, lse, **kw), lse


def _bwd_err(got, want) -> float:
    """Largest |error| over the largest |value| of the plain result."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda, case):
    b, h, vh, sq, sk, d, kw = CUDA_BWD_CASES[case]
    q, k, v, do = _cuda_inputs(cuda, b, h, vh, sq, sk, d)
    out, lse = _fwd_with_lse(q, k, v, **kw)
    _, want_lse = FA._flash_fwd_plain(q, k, v, **{"kv_len": None, "window": 0,
                                                  "causal": True,
                                                  "pos_offset": 0, **kw})
    valid = want_lse > -1e29
    torch.testing.assert_close(lse[valid], want_lse.float()[valid],
                               rtol=1e-3, atol=1e-3)
    before = FA.launches_bwd
    got = FA.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    assert FA.launches_bwd == before + 1
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g.float()).all(), name
        assert _bwd_err(g, w) <= 2e-2, (name, _bwd_err(g, w))
    again = FA.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_flash_bwd_kernel_refuses_d48(cuda):
    q, k, v, do = _cuda_inputs(cuda, 1, 2, 1, 64, 64, 48)
    lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=cuda)
    before = FA.launches_bwd
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_bwd_cuda(q, k, v, q, lse, do)
    assert FA.launches_bwd == before


@pytest.mark.cuda
def test_forward_bits_do_not_depend_on_lse(cuda):
    q, k, v, _ = _cuda_inputs(cuda, 1, 16, 2, 300, 300, 128)
    plain = FA.flash_attention_cuda(q, k, v, window=50)
    with_lse, _ = _fwd_with_lse(q, k, v, window=50)
    assert torch.equal(plain, with_lse)


# (arch, flash forward launches and backward calls per remat step): each
# decoder attention call (self, and cross) twice forward and once backward,
# the encoder's once each way; danube at its own head_dim 120 (the padded
# kernels), jamba one 8-block period (one attention block), xlstm none
CARD_TRAIN_CASES = {"qwen2.5-3b": (4, 2), "dbrx-132b": (4, 2),
                    "jamba-1.5-large-398b": (2, 1), "xlstm-125m": (0, 0),
                    "seamless-m4t-medium": (10, 6),
                    "h2o-danube-3-4b": (4, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CARD_TRAIN_CASES))
def test_train_step_on_card_matches_cpu(cuda, arch):
    cfg = reduce_config(get_config(arch), layers=2, d_model=256,
                        heads=4, d_ff=512, vocab=1024)
    if arch == "h2o-danube-3-4b":
        cfg = dataclasses.replace(cfg, head_dim=120)
    model = build_model(cfg)
    params, _ = init_train_state(model, torch.Generator().manual_seed(0),
                                 "cpu")
    shape = ShapeSpec("t", 128, 2, "train")
    batch = SyntheticTokenStream(cfg, shape, DataConfig(seed=1),
                                 device="cpu").batch(0)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        step = build_train_step(model, TrainConfig())
        fa, fb = FA.launches, FA.launches_bwd
        p2, _, m = step(p, O.init_opt_state(p), b)
        if dev != "cpu":
            # remat: each layer's forward runs twice, its backward once
            assert (FA.launches - fa, FA.launches_bwd - fb) == \
                CARD_TRAIN_CASES[arch]
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [t.cpu() for t in tree_leaves(p2)])
    (l0, g0, p0), (l1, g1, p1) = out.values()
    np.testing.assert_allclose(l1, l0, rtol=2e-2)
    np.testing.assert_allclose(g1, g0, rtol=2e-2)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(_np(a), _np(b), **BF16)
