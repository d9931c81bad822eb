"""The port's recurrent mixers (Mamba, mLSTM, sLSTM), encoder-decoder and
VLM front ends, and the dense-cache grouped decode, against the reference
on the CPU at ``reduce_config`` widths.

Inputs come from a numpy seed and go to both packages. Tolerances:

- a mixer function in fp32 (params, inputs and state): 1e-5 relative, the
  reference's own fp32 computation in another framework (einsum blocking,
  ``exp`` and ``log_sigmoid`` round differently in the last bits);
- a mixer or a model in bf16: rtol 5e-2 / atol 1e-1 (the lockstep's
  ``DualEngine`` tolerance), argmax equal or a tie under its rule;
- the grouped decode against the port's own plain decode: rtol 3e-2 /
  atol 6e-2 (``tests/test_offload_equivalence.py``), bitwise in fp32.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.reduced import reduce_config as jreduce  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan  # noqa: E402
from repro_torch.core.memory_manager import (  # noqa: E402
    OffloadRuntime, merge_stacked, split_model_params)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.frontends import stub_embeddings  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import params_from_numpy, tree_map  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=1e-1)
GROUPED_TOL = dict(rtol=3e-2, atol=6e-2)
B, S = 2, 12

# (arch, layers): jamba at two 8-block periods, so a plan has a group
FAMILIES = {"jamba-1.5-large-398b": 16, "xlstm-125m": 4,
            "seamless-m4t-medium": 4, "paligemma-3b": 4}


def _cfgs(arch, layers):
    jcfg = jreduce(jget_config(arch), layers=layers)
    cfg = reduce_config(get_config(arch), layers=layers)
    return jcfg, cfg


_MODELS: dict = {}


def _models(arch):
    """(jax model, jax params, port model, port params), built once."""
    if arch not in _MODELS:
        jcfg, cfg = _cfgs(arch, FAMILIES[arch])
        jm, tm = jbuild(jcfg), build_model(cfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        jp = _randomize_constants(jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _randomize_constants(tree, seed=7):
    """Zeros/ones-initialised leaves (biases, a_log, d_skip, norm scales)
    get small random values, so every parameter moves the output."""
    rng = np.random.default_rng(seed)

    def one(a):
        x = np.asarray(a, np.float32)
        if np.all(x == x.flat[0]):
            x = x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
            return jnp.asarray(x).astype(a.dtype)
        return a
    return jax.tree.map(one, tree)


def _inputs(cfg, seed=0):
    """Numpy inputs of one batch: tokens, and the frontend's or the
    encoder's stub embeddings (bf16 bits, fed to both packages)."""
    rng = np.random.default_rng(seed)
    out = {}
    n_front = 0
    if cfg.encoder_layers > 0:
        out["enc_embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                             * 0.02).astype(jnp.bfloat16)
    elif cfg.frontend is not None:
        n_front = cfg.frontend.num_positions
        out["frontend_embeds"] = (rng.standard_normal(
            (B, n_front, cfg.d_model)) * 0.02).astype(jnp.bfloat16)
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (B, S - n_front)).astype(np.int32)
    return out


def _to_port(inputs):
    return {k: params_from_numpy(v, "cpu") for k, v in inputs.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _argmax_or_tie(got, want, tol):
    """The DualEngine token gate: equal argmax, or the reference scores the
    two picks within the tolerance of each other (and so does the port)."""
    got, want = _np(got), _np(want)
    for g, w in zip(got, want):
        gi, wi = int(np.argmax(g)), int(np.argmax(w))
        if gi == wi:
            continue
        tie = tol["atol"] + tol["rtol"] * abs(float(w[wi]))
        assert w[wi] - w[gi] <= tie and g[gi] - g[wi] <= tie, (gi, wi)


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a dict/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# The weights bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_bridge_every_leaf(arch):
    """Every leaf of the reference's tree (Mamba, mLSTM, sLSTM, encoder,
    cross attention, frontends' models) reaches the port at the same path,
    with the same shape and the same bits, and the port's own spec has
    exactly those paths and shapes."""
    jm, jp, tm, tp = _models(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(a) for kp, a in jflat}
    got = dict(_paths(tp))
    spec = dict(_paths(T.tree_map_spec(lambda s: s, tm.spec)))
    assert set(got) == set(want) == set(spec)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape == tuple(spec[path].shape), path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.uint16).view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), a), path


# ---------------------------------------------------------------------------
# The mixers, function by function
# ---------------------------------------------------------------------------

_MIXERS = {"mamba": ("jamba-1.5-large-398b", 0, 40),
           "mlstm": ("xlstm-125m", 0, 12), "slstm": ("xlstm-125m", 1, 12)}


def _block_params(arch, j, dtype):
    """Pattern position j's mixer params, unit 0, as numpy in ``dtype``."""
    _, jp, _, _ = _models(arch)
    return jax.tree.map(lambda a: np.asarray(a[0]).astype(dtype),
                        jp["blocks"][j]["attn"])


def _both(tree, dtype):
    """A numpy tree as (jax arrays, CPU tensors) in ``dtype``."""
    tree = jax.tree.map(lambda a: np.asarray(a).astype(dtype), tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(dtype):
    rng = np.random.default_rng(3)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    x = rng.standard_normal((B, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    st = rng.standard_normal((B, 3, 16)).astype(np.float32)
    (jx, jw, jb, js), (tx, tw, tb, ts) = _both((x, w, b, st), dt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for jstate, tstate in ((None, None), (js, ts)):
        jy, jn = JL._causal_conv(jx, jw, jb, jstate)
        ty, tn = L._causal_conv(tx, tw, tb, tstate)
        _close(ty, jy, tol)
        _close(tn, jn, tol)


def _mixer_fns(mixer):
    return {"mamba": (JL.apply_mamba_seq, JL.apply_mamba_decode,
                      L.apply_mamba_seq, L.apply_mamba_decode),
            "mlstm": (JL.apply_mlstm_seq, JL.apply_mlstm_decode,
                      L.apply_mlstm_seq, L.apply_mlstm_decode),
            "slstm": (JL.apply_slstm_seq, JL.apply_slstm_decode,
                      L.apply_slstm_seq, L.apply_slstm_decode)}[mixer]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", list(_MIXERS))
def test_mixer_seq_then_decode(mixer, dtype):
    """``apply_<mixer>_seq`` over S positions (Mamba: 40, two scan chunks,
    the second padded), its final state, and two ``apply_<mixer>_decode``
    steps from that state, against the reference's functions."""
    arch, j, s = _MIXERS[mixer]
    jm, _, tm, _ = _models(arch)
    dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jseq, jdec, tseq, tdec = _mixer_fns(mixer)
    jp, tp = _both(_block_params(arch, j, np.float32), dt)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, s + 2, tm.cfg.d_model)).astype(np.float32)
    jx, tx = _both(x, dt)
    jy, jst = jax.jit(lambda p, x: jseq(jm.cfg, p, x))(jp, jx[:, :s])
    ty, tst = tseq(tm.cfg, tp, tx[:, :s])
    _close(ty, jy, tol)
    for k in jst:
        _close(tst[k], jst[k], tol)
    # decode from the reference's state (fed to both), one position a step
    state = jax.tree.map(np.asarray, jst)
    for t in (s, s + 1):
        jc, tc = (jax.tree.map(jnp.asarray, state),
                  params_from_numpy(state, "cpu"))
        jy1, jst1 = jax.jit(lambda p, x, c: jdec(jm.cfg, p, x, c))(
            jp, jx[:, t:t + 1], jc)
        ty1, tst1 = tdec(tm.cfg, tp, tx[:, t:t + 1], tc)
        _close(ty1, jy1, tol)
        for k in jst1:
            _close(tst1[k], jst1[k], tol)
        state = jax.tree.map(np.asarray, jst1)


def test_mamba_state_continuity():
    """seq(S) then decode(1) is the last row of seq(S + 1) (fp32, the
    port alone): the carried conv and SSM states are the scan's."""
    _, _, tm, _ = _models("jamba-1.5-large-398b")
    _, tp = _both(_block_params("jamba-1.5-large-398b", 0, np.float32),
                  np.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 33, tm.cfg.d_model)).astype(np.float32))
    _, st = L.apply_mamba_seq(tm.cfg, tp, x[:, :32])
    y1, _ = L.apply_mamba_decode(tm.cfg, tp, x[:, 32:], st)
    y_all, _ = L.apply_mamba_seq(tm.cfg, tp, x)
    _close(y1[:, 0], y_all[:, 32], F32_TOL)


# ---------------------------------------------------------------------------
# Whole models: prefill -> decode against the reference
# ---------------------------------------------------------------------------


def _model_dtype(arch, dtype):
    """The arch's models with params in ``dtype`` (bf16 as initialised)."""
    jm, jp, tm, tp = _models(arch)
    if dtype == "bfloat16":
        return jm, jp, tm, tp
    jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a, jp)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# bf16 for the families without MoE, fp32 for those whose reference runs
# in fp32. In bf16 the reduced jamba's 4-expert top-2 routers sit near
# ties: the two frameworks' bf16 roundings route tokens apart in 5 of its 8
# MoE calls of a prefill (ROADMAP Queue C 8), and the Mamba states carry
# the difference on, so its bf16 model is held block by block
# (test_jamba_blocks_bf16) and whole in fp32. The reference's encoder
# casts its input to bf16 and its layer scan then refuses fp32 params, so
# seamless runs in bf16 only
MODEL_CASES = [(a, "float32") for a in FAMILIES
               if a != "seamless-m4t-medium"] + [
    (a, "bfloat16") for a in FAMILIES if a != "jamba-1.5-large-398b"]
# a whole reduced model in fp32, XLA against PyTorch: each layer's fp32
# rounding differs in the last bits and 4-16 layers compound it. xlstm and
# paligemma hold 1e-5; jamba's 16 layers reach 1.27e-5 absolute, so the
# whole-model bound is 3e-5
MODEL_F32_TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch,dtype", MODEL_CASES)
def test_model_prefill_decode_matches_reference(arch, dtype, impl):
    """``Model.prefill`` then three ``decode_step``s (greedy tokens from
    the reference) against the JAX model: logits at the dtype's tolerance,
    argmax equal or a tie. ``impl`` is the port's prefill attention: dense,
    or the flash kernel's plain version (the reference runs its
    ``attn_chunked``)."""
    jm, jp, tm, tp = _model_dtype(arch, dtype)
    tol = MODEL_F32_TOL if dtype == "float32" else BF16_TOL
    inputs = _inputs(tm.cfg)
    cache_len = S + 4
    jl, jc, jenc = jax.jit(lambda p, i: jm.prefill(p, i, cache_len))(
        jp, jax.tree.map(jnp.asarray, inputs))
    tl, tc, tenc = tm.prefill(tp, _to_port(inputs), cache_len, attn_impl=impl)
    _close(tl, jl, tol)
    _argmax_or_tie(tl, jl, tol)
    assert (tenc is None) == (jenc is None)
    jstep = jax.jit(lambda *a: jm.decode_step(*a))
    for t in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jstep(jp, jnp.asarray(tok), jnp.asarray(pos), jc, jenc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok),
                                torch.from_numpy(pos), tc, tenc)
        _close(tl, jl, tol)
        _argmax_or_tie(tl, jl, tol)


def _watch_routes(monkeypatch, jroutes, troutes):
    """Record both frameworks' expert sets ([B, S, k], ids ascending) at
    every MoE call: the port's from ``layers.route``, the reference's from
    its router inside the compiled call (an ordered debug callback)."""
    route, jmoe = L.route, JL.apply_moe

    def watched(cfg, p, x):
        probs, top_p, top_i = route(cfg, p, x)
        troutes.append(top_i.sort(dim=-1).values.numpy())
        return probs, top_p, top_i

    def jwatched(cfg, p, x):
        logits = jnp.einsum("bsd,de->bse", x, p["router"],
                            preferred_element_type=jnp.float32)
        _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                 cfg.moe.top_k)
        jax.debug.callback(
            lambda t: jroutes.append(np.sort(np.asarray(t), -1)), top_i,
            ordered=True)
        return jmoe(cfg, p, x)

    monkeypatch.setattr(L, "route", watched)
    monkeypatch.setattr(JL, "apply_moe", jwatched)


@pytest.mark.parametrize("j", range(8))
def test_jamba_blocks_bf16(j, monkeypatch):
    """Each of jamba's eight pattern positions in bf16 (Mamba or attention,
    dense or MoE MLP), fed the same input: ``apply_block_seq`` then two
    ``apply_block_decode`` steps from its cache, against the reference's.
    In a MoE block a token whose two routers chose different experts (a
    bf16 tie, ROADMAP Queue C 8) is excused the tolerance, and at most a
    quarter of the tokens may be."""
    from repro.models import transformer as JT

    jm, jp, tm, tp = _models("jamba-1.5-large-398b")
    blk = tm.cfg.pattern[j]
    jroutes, troutes = [], []
    _watch_routes(monkeypatch, jroutes, troutes)
    jb = jax.tree.map(lambda a: a[1], jp["blocks"][j])
    tb = T.unit_slice(tp["blocks"][j], 1)
    rng = np.random.default_rng(20 + j)
    x = (rng.standard_normal((B, S + 2, tm.cfg.d_model))
         ).astype(jnp.bfloat16)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jctx = JT.SeqCtx(positions=jnp.asarray(pos), want_cache=True,
                     cache_len=S + 2, virtual_kv=jm.virtual_kv)
    tctx = T.SeqCtx(positions=torch.from_numpy(pos), want_cache=True,
                    cache_len=S + 2, virtual_kv=tm.virtual_kv)
    jy, jc, _ = jax.jit(lambda p, x: JT.apply_block_seq(
        jm.cfg, blk, p, x, jctx))(jb, jnp.asarray(x[:, :S]))
    ty, tc, _ = T.apply_block_seq(tm.cfg, blk, tb,
                                  params_from_numpy(x[:, :S], "cpu"), tctx)
    outs = [(ty, jy)]
    for t in (S, S + 1):
        p1 = np.full((B,), t, np.int32)
        jy, jc = jax.jit(lambda p, x, c: JT.apply_block_decode(
            jm.cfg, blk, p, x, jnp.asarray(p1), c, jm.virtual_kv))(
            jb, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = T.apply_block_decode(tm.cfg, blk, tb,
                                      params_from_numpy(x[:, t:t + 1], "cpu"),
                                      torch.from_numpy(p1), tc, tm.virtual_kv)
        outs.append((ty, jy))
    jax.effects_barrier()
    if blk.mlp == "moe":
        assert len(jroutes) == len(troutes) == len(outs)
    apart = total = 0
    for i, (ty, jy) in enumerate(outs):
        got, want = _np(ty), _np(jy)
        ok = np.isclose(got, want, **BF16_TOL).all(-1)           # [B, S]
        if blk.mlp == "moe":
            same = (jroutes[i] == troutes[i]).all(-1)
            apart += int((~same).sum())
            total += same.size
            ok |= ~same
        assert ok.all(), (j, blk, np.abs(got - want).max())
    assert apart <= total / 4, (apart, total)


def test_stub_embeddings_shape():
    cfg = reduce_config(get_config("paligemma-3b"))
    x = stub_embeddings(cfg, 3, cfg.frontend.num_positions,
                        torch.Generator().manual_seed(0), "cpu")
    assert x.shape == (3, cfg.frontend.num_positions, cfg.d_model)
    assert x.dtype == torch.bfloat16 and float(x.float().std()) < 0.05


# ---------------------------------------------------------------------------
# The dense-cache grouped decode against the plain step
# ---------------------------------------------------------------------------


def _clone(tree):
    return tree_map(torch.clone, tree)


def _prefilled(tm, tp, cache_len=S + 4):
    inputs = _to_port(_inputs(tm.cfg))
    logits, caches, enc_pos = tm.prefill(tp, inputs, cache_len)
    tok = logits.argmax(-1).to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    return inputs, caches, enc_pos, tok, pos


@pytest.mark.parametrize("interval", [1, 2, NO_OFFLOAD])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_grouped_decode_matches_plain(arch, interval):
    """``OffloadRuntime.decode_step`` over the split caches against
    ``Model.decode_step`` on the same caches, two steps: logits at the
    grouped tolerance, and the caches it updated in place, merged back,
    against the plain step's new caches."""
    _, _, tm, tp = _models(arch)
    _, caches, enc_pos, tok, pos = _prefilled(tm, tp)
    _, r = T.pattern_info(tm.cfg)
    plan = OffloadPlan(num_units=r, interval=interval)
    rt = OffloadRuntime(tm, plan, device="cpu")
    psplit = split_model_params(tp, plan)
    plain = _clone(caches)
    csplit = rt.split_caches(_clone(caches))
    for t in range(2):
        want, plain = tm.decode_step(tp, tok, pos + t, plain, enc_pos)
        got, same = rt.decode_step(psplit, tok, pos + t, csplit, enc_pos)
        assert same is csplit
        _close(got, want, GROUPED_TOL)
        tree_map(lambda a, b: _close(a, b, GROUPED_TOL),
                 merge_stacked(csplit, plan), plain)
        tok = want.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch,layers", [("deepseek-7b", 6),
                                         ("xlstm-125m", 4)])
def test_grouped_decode_bitwise_f32(arch, layers):
    """In fp32 the grouped decode is bit-exact against the plain step at
    every interval — offloading is a placement, never a math change (the
    reference's ``test_decode_equivalence_exact_f32``)."""
    cfg = reduce_config(get_config(arch), layers=layers)
    tm = build_model(cfg)
    tp = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                  tm.init(torch.Generator().manual_seed(0), "cpu"))
    _, caches, enc_pos, tok, pos = _prefilled(tm, tp)
    want, _ = tm.decode_step(tp, tok, pos, _clone(caches), enc_pos)
    _, r = T.pattern_info(cfg)
    for interval in (1, 2, 3, NO_OFFLOAD):
        plan = OffloadPlan(num_units=r, interval=interval)
        rt = OffloadRuntime(tm, plan, device="cpu")
        got, _ = rt.decode_step(split_model_params(tp, plan), tok, pos,
                                rt.split_caches(_clone(caches)), enc_pos)
        assert torch.equal(got, want), interval


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "paligemma-3b",
                                  "jamba-1.5-large-398b"])
def test_grouped_prefill_feeds_grouped_decode(arch):
    """``OffloadRuntime.prefill`` with the encoder's or the frontend's
    inputs equals ``Model.prefill``, and its split caches feed
    ``decode_step`` directly."""
    _, _, tm, tp = _models(arch)
    inputs, caches, enc_pos, tok, pos = _prefilled(tm, tp)
    _, r = T.pattern_info(tm.cfg)
    plan = OffloadPlan(num_units=r, interval=2)
    rt = OffloadRuntime(tm, plan, device="cpu")
    psplit = split_model_params(tp, plan)
    want, _, _ = tm.prefill(tp, inputs, S + 4)
    got, csplit, enc2 = rt.prefill(psplit, inputs, S + 4)
    assert torch.equal(got, want)
    assert (enc2 is None) == (enc_pos is None)
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("cache"),
             merge_stacked(csplit, plan), caches)
    logits, _ = rt.decode_step(psplit, tok, pos, csplit, enc2)
    want, _ = tm.decode_step(tp, tok, pos, caches, enc_pos)
    _close(logits, want, GROUPED_TOL)


def test_model_cache_spec_and_init_cache():
    """``init_cache`` materialises the reference's cache tree: per pattern
    position the mixer's state (and, for enc-dec, the cross K/V without
    positions), stacked over the periods."""
    cfg = reduce_config(get_config("seamless-m4t-medium"), layers=4)
    tm = build_model(cfg)
    c = tm.init_cache(torch.Generator().manual_seed(0), "cpu", 2, 16,
                      enc_len=10)
    assert set(c[0]) == {"self", "cross"} and set(c[0]["cross"]) == {"k", "v"}
    assert c[0]["cross"]["k"].shape == (4, 2, 10, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)
    jcfg = reduce_config(get_config("jamba-1.5-large-398b"), layers=16)
    jc = build_model(jcfg).init_cache(torch.Generator(), "cpu", 2, 16)
    assert set(jc[0]["self"]) == {"conv", "ssm"}
    assert jc[0]["self"]["ssm"].dtype == torch.float32
    assert set(jc[4]["self"]) == {"k", "v", "pos"}
    x = reduce_config(get_config("xlstm-125m"))
    xc = build_model(x).init_cache(torch.Generator(), "cpu", 2, 16)
    assert set(xc[0]["self"]) == {"C", "n", "m"}
    assert set(xc[1]["self"]) == {"c", "n", "h", "m"}
    # the split spec describes the split caches, leaf for leaf
    rt = OffloadRuntime(tm, OffloadPlan(4, 3), device="cpu")
    split = rt.split_caches(c)
    spec = rt.cache_spec_split(2, 16, enc_len=10)
    for sec in ("resident", "offloaded", "tail"):
        got = [tuple(t.shape) for t in T.tree_leaves(split[sec])]
        want = [s.shape for s in T.tree_leaves(
            spec[sec], is_leaf=lambda v: isinstance(v, T.TensorSpec))]
        assert got == want, sec
