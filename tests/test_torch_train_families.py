"""Training of every model family the port has beyond deepseek's, qwen's and
gemma's, held against the reference on the CPU: the MoE decoders
(grok-1-314b, dbrx-132b), jamba-1.5-large-398b (one whole period of Mamba,
MoE and attention), xlstm-125m (mLSTM, sLSTM), seamless-m4t-medium (the
encoder and cross attention) and h2o-danube-3-4b (a sliding window, cut
to 8 so it masks at the 16-token batch). Weights are the reference's
``Model.init(PRNGKey(0))`` bridged through ``params_from_numpy``, the
batch the seeded stream both packages give bit for bit.

Tolerances, each with its reason:
- loss, cross entropy and the MoE aux loss rtol 2e-2 in bf16 (bf16 weights
  and activations, rounded at different places by the two frameworks);
  1e-5 in fp32;
- the whole bf16 gradient within relative L2 0.02 (``test_torch_train``),
  on the reference's expert sets where a MoE token was routed apart (each
  such token within ``ROUTE_TIE`` of a tie, ROADMAP Queue C 8, but the
  one listed in ``APART_PAST_TIE``); jamba and seamless at bounds of their
  own (``BOUNDS``), set between the sound port's readings and broken
  ports' (``CONTROLS``); jamba's does not meet the 0.02 asked of it
  (ROADMAP Queue C 13);
- every fp32 leaf within relative L2 1e-5 (the same algorithm in another
  framework);
- three fp32 train steps: loss and ``grad_norm`` at 1e-4 (jamba's and
  xlstm's ``grad_norm`` at 1e-3, ``GRAD_NORM_RTOL``), each leaf's change
  within 0.02 (readings at the test);
- seamless-m4t-medium only in bf16 (the reference casts the encoder input
  to bf16, ``src/repro/models/model.py:62``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_families.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

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
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_loop import build_train_step as jbuild_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.reduced import reduce_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.spec import (params_from_numpy, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training.train_loop import (TrainConfig,  # noqa: E402
                                             build_train_step)

BF16_RTOL = 2e-2
REL_L2 = 0.02
SHAPE = ShapeSpec("tiny", 16, 2, "train")
JSHAPE = JShape("tiny", 16, 2, "train")
# a token whose top-k boundary is closer than this (the gap of the router's
# k-th and (k+1)-th probabilities over the k-th) may route through other
# experts in one framework than in the other (chip_smoke's ROUTE_TIE)
ROUTE_TIE = 2e-2

# reduce_config at 2 layers; jamba rounds up to its whole 8-block period
ARCHS = ("grok-1-314b", "dbrx-132b", "jamba-1.5-large-398b", "xlstm-125m",
         "seamless-m4t-medium", "h2o-danube-3-4b")

# the share of a MoE call's tokens the two frameworks may route through
# different experts in bf16 (chip_smoke's MOE_ROUTED_APART, Queue C 8)
MOE_ROUTED_APART = 0.25
# The bf16 gradient's bounds (whole, each leaf) by relative L2 where 0.02
# does not hold, each set between the sound port's readings and a broken
# port's, which the test runs as its control:
# - seamless-m4t-medium (no fp32 on the reference): sound whole 0.0221,
#   leaves up to 0.0488; with the cross attention's gradient into the
#   encoder detached whole 0.626, 12 of 32 leaves past 0.1, up to 1.0;
#   with the cross attention blind to the last of the 16 encoder frames
#   (one in 16, as 64 keys of the card's 1024) whole 0.0711, leaves up to
#   0.202.
# - jamba-1.5-large-398b (8 blocks, bf16 rounding grows through the
#   Mamba stack: each block's output reads 0.006-0.011 against the
#   reference's on the same input, the eighth block's hidden state 0.025;
#   the reference's own bf16 gradient reads 0.329 against its fp32 one,
#   the port's 0.326): sound whole 0.134 (0.120 on the reference's
#   routes), leaves up to 0.209 (0.153); on the reference's routes, with
#   the Mamba decay's gradient detached (``a`` in ``_ssm_scan``) 7 leaves
#   at 1.0, and with the MoE combine's weights detached whole 0.390 and
#   43 leaves past 0.3.
BOUNDS = {"seamless-m4t-medium": (0.05, 0.1),
          "jamba-1.5-large-398b": (0.2, 0.3)}
# the fp32 lockstep's ``grad_norm`` tolerance where 1e-4 does not hold:
# Adam moves a weight by about lr whatever its gradient's size, so the last
# bits of a near-zero gradient move the next step's norm. Readings: jamba
# 6.0e-4 (its third step), xlstm 1.19e-4 (its second); the other archs
# 1.9e-5 at most
GRAD_NORM_RTOL = {"jamba-1.5-large-398b": 1e-3, "xlstm-125m": 1e-3}
# the MoE tokens the two frameworks routed apart in bf16 farther than
# ROUTE_TIE from a tie: (arch, MoE call in forward order, batch row,
# position) -> the margin read (the lesser of the two routers')
APART_PAST_TIE = {("jamba-1.5-large-398b", 2, 1, 5): 0.0845}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the optimizer updates its tensors in place."""
    return t.detach().float().numpy().copy()


def _flat(xs) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in xs])


def _moe_calls(cfg) -> int:
    """MoE calls in one forward: MoE positions of the pattern times its
    repeats."""
    return sum(b.mlp == "moe" for b in cfg.pattern) * T.pattern_info(cfg)[1]


@contextlib.contextmanager
def _recorded_routes():
    """Both frameworks' routers at every MoE call while open: the
    reference's fp32 probabilities and top-k ids (in its order) through an
    ordered ``jax.debug.callback`` inside the compiled call, the port's
    through ``layers.route``. Yields (reference calls, port calls), each a
    list of (probs [B,S,E], ids [B,S,k]) numpy pairs."""
    jcalls, tcalls = [], []
    route, jmoe = L.route, JL.apply_moe

    def watched(cfg, p, x):
        probs, top_p, top_i = route(cfg, p, x)
        tcalls.append((probs.detach().numpy().copy(), top_i.numpy().copy()))
        return probs, top_p, top_i

    def jwatched(cfg, p, x):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x, p["router"],
            preferred_element_type=jnp.float32), axis=-1)
        _, top_i = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda a, t: jcalls.append(
            (np.asarray(a), np.asarray(t))), probs, top_i, ordered=True)
        return jmoe(cfg, p, x)

    L.route, JL.apply_moe = watched, jwatched
    try:
        yield jcalls, tcalls
    finally:
        L.route, JL.apply_moe = route, jmoe


@contextlib.contextmanager
def _forced_routes(sets):
    """The port's router with each MoE layer's top-k ids replaced by
    ``sets`` (one [B,S,k] array per layer, in forward order), their
    probabilities gathered from its own softmax. A layer is known by its
    router's storage, so remat's recompute gets the same sets."""
    route, seen = L.route, {}

    def forced(cfg, p, x):
        probs, _, _ = route(cfg, p, x)
        i = seen.setdefault(p["router"].data_ptr(), len(seen))
        top_i = torch.from_numpy(sets[i].astype(np.int64))
        return probs, probs.gather(-1, top_i), top_i

    L.route = forced
    try:
        yield
    finally:
        L.route = route


def _route_margin(probs: np.ndarray, k: int) -> np.ndarray:
    """How far each token's top-k routing lies from a tie: the gap between
    its k-th and (k+1)-th router probabilities over the k-th."""
    top = -np.sort(-probs, axis=-1)
    return (top[..., k - 1] - top[..., k]) / top[..., k - 1]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    arch = request.param
    jcfg = jreduce(jget_config(arch), layers=2)
    cfg = reduce_config(get_config(arch), layers=2)
    jm, tm = jbuild(jcfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jb = JStream(jcfg, JSHAPE, JData(seed=1)).batch(0)
    tb = SyntheticTokenStream(cfg, SHAPE, DataConfig(seed=1), device="cpu") \
        .batch(0)
    return jm, jp, jb, tm, tp, tb


def _jax_grads(jm, jp, jb):
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=True), has_aux=True))(jp)
    return float(loss), {k: float(v) for k, v in parts.items()}, g


def _port_grads(tm, tp, tb, remat=True, unused_zero=False):
    """(loss, its parts, the gradient of every leaf); ``unused_zero``: a
    leaf the loss does not reach gets zeros (a broken port's control)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    it = iter(leaves)
    loss, parts = tm.loss_fn(tree_map(lambda _: next(it), tp), tb,
                             remat=remat)
    return (loss.detach(), {k: float(v.detach()) for k, v in parts.items()},
            torch.autograd.grad(loss, leaves, allow_unused=unused_zero,
                                materialize_grads=unused_zero))


@pytest.fixture(scope="module")
def bf16_run(bridged):
    """The reference's and the port's loss, parts and gradient in bf16 from
    the same weights and batch, with both routers recorded (the first
    forward's calls: remat's recompute repeats them)."""
    jm, jp, jb, tm, tp, tb = bridged
    with _recorded_routes() as (jcalls, tcalls):
        jloss, jparts, jg = _jax_grads(jm, jp, jb)
        loss, parts, got = _port_grads(tm, tp, tb)
    n = _moe_calls(tm.cfg)
    return {"ref": (jloss, jparts, jax.tree.leaves(
                jax.tree.map(np.asarray, jg))),
            "port": (float(loss), parts, [_np(g) for g in got]),
            "routes": (jcalls[:n], tcalls[:n])}


def test_loss_and_parts_match_reference(bridged, bf16_run):
    """The loss, its cross entropy and its aux term: the MoE archs' aux
    loss (0.01 of it in the loss) against the reference's, positive; 0 in
    both elsewhere."""
    tm = bridged[3]
    jloss, jparts, _ = bf16_run["ref"]
    loss, parts, _ = bf16_run["port"]
    np.testing.assert_allclose(loss, jloss, rtol=BF16_RTOL)
    np.testing.assert_allclose(parts["xent"], jparts["xent"], rtol=BF16_RTOL)
    if tm.cfg.moe is not None:
        assert parts["aux"] > 0 and jparts["aux"] > 0
        np.testing.assert_allclose(parts["aux"], jparts["aux"],
                                   rtol=BF16_RTOL)
    else:
        assert parts["aux"] == 0.0 and jparts["aux"] == 0.0


# the broken ports of ``BOUNDS``' controls, each a module function replaced
_SCAN, _COMBINE, _CROSS = L._ssm_scan, L._moe_combine, T._cross_attn_seq
CONTROLS = {
    "seamless-m4t-medium": [
        (T, "_cross_attn_seq", lambda cfg, p, x, ctx: _CROSS(
            cfg, p, x, dataclasses.replace(ctx,
                                           enc_out=ctx.enc_out.detach()))),
        (T, "_cross_attn_seq", lambda cfg, p, x, ctx: _CROSS(
            cfg, p, x, dataclasses.replace(
                ctx, enc_out=ctx.enc_out[:, :-1],
                enc_pos=None if ctx.enc_pos is None
                else ctx.enc_pos[:, :-1])))],
    "jamba-1.5-large-398b": [
        (L, "_ssm_scan", lambda dt, u, b, c, a, chunk: _SCAN(
            dt, u, b, c, a.detach(), chunk=chunk)),
        (L, "_moe_combine", lambda cfg, ye, top_p, *rest: _COMBINE(
            cfg, ye, top_p.detach(), *rest))],
}


def test_grads_match_jax_grad(bridged, bf16_run):
    """bf16: the whole gradient within relative L2 0.02; seamless and jamba
    at their own ``BOUNDS``, whole and per leaf, each beside its broken
    ports (``CONTROLS``), which must fail them. In a MoE arch the tokens
    the two routers sent to different experts are counted, at most a
    quarter of a call's (Queue C 8's share), each within ``ROUTE_TIE`` of a
    tie or listed in ``APART_PAST_TIE`` with the margin read there; when
    there are any, the port runs again
    on the reference's expert sets, forced, and the gradient is held on the
    same routes: no token is excused."""
    *_, tm, tp, tb = bridged
    want = bf16_run["ref"][2]
    got = bf16_run["port"][2]
    assert [g.shape for g in got] == [w.shape for w in want]
    name = tm.cfg.name.removesuffix("-reduced")
    whole, leaf = BOUNDS.get(name, (REL_L2, None))
    routes = contextlib.nullcontext
    if tm.cfg.moe is not None:
        jcalls, tcalls = bf16_run["routes"]
        assert len(jcalls) == len(tcalls) == _moe_calls(tm.cfg)
        apart = [(np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
                 for (_, ji), (_, ti) in zip(jcalls, tcalls)]
        for call, ((jprobs, ji), (tprobs, _), a) in enumerate(
                zip(jcalls, tcalls, apart)):
            assert a.mean() <= MOE_ROUTED_APART
            k = ji.shape[-1]
            margin = np.minimum(_route_margin(jprobs, k),
                                _route_margin(tprobs, k))
            for row, pos in np.argwhere(a & (margin > ROUTE_TIE)):
                listed = APART_PAST_TIE.get((name, call, row, pos))
                assert listed is not None and abs(
                    margin[row, pos] - listed) < 1e-3, \
                    (call, row, pos, margin[row, pos])
        if any(a.any() for a in apart):
            routes = lambda: _forced_routes([ji for _, ji in jcalls])
            with routes():
                got = [_np(g) for g in _port_grads(tm, tp, tb)[2]]
    assert _rel_l2(_flat(got), _flat(want)) <= whole
    if leaf is not None:
        assert max(_rel_l2(g, w) for g, w in zip(got, want)) <= leaf
    for module, attr, broken in CONTROLS.get(name, ()):
        sound = getattr(module, attr)
        setattr(module, attr, broken)
        try:
            with routes():
                bad = [_np(g) for g in _port_grads(tm, tp, tb,
                                                   unused_zero=True)[2]]
        finally:
            setattr(module, attr, sound)
        assert _rel_l2(_flat(bad), _flat(want)) > whole \
            or max(_rel_l2(g, w) for g, w in zip(bad, want)) > leaf, attr


@pytest.fixture(scope="module")
def fp32(bridged):
    jm, jp, jb, tm, tp, tb = bridged
    return (jax.tree.map(lambda x: x.astype(jnp.float32), jp),
            tree_map(lambda t: t.float(), tp))


def test_grads_match_jax_grad_per_leaf_fp32(bridged, fp32):
    """fp32 weights on both sides, where the point is the algorithm (the
    MoE sort, gathers and capacity drop, the Mamba scan, the mLSTM / sLSTM
    loops, the window, remat): loss and its parts within 1e-5, every leaf
    within relative L2 1e-5."""
    jm, _, jb, tm, _, tb = bridged
    if tm.cfg.name.startswith("seamless"):
        pytest.skip("the reference casts the encoder input to bf16 "
                    "(src/repro/models/model.py:62): bf16 only")
    jp32, tp32 = fp32
    jloss, jparts, jg = _jax_grads(jm, jp32, jb)
    loss, parts, got = _port_grads(tm, tp32, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(parts[key], jparts[key], rtol=1e-5)
    for g, w in zip(got, jax.tree.leaves(jg)):
        assert _rel_l2(_np(g), np.asarray(w)) <= 1e-5


def _changes(params, start):
    return [_np(t) - z for t, z in zip(params, start)]


def _jchanges(params, start):
    return [np.asarray(w, np.float32) - z for w, z in zip(
        jax.tree.leaves(jax.tree.map(np.asarray, params)), start)]


def test_three_train_steps_in_lockstep(bridged, fp32):
    """Three train steps in lockstep with the reference's. fp32 at lr 1e-2:
    loss at 1e-4, ``grad_norm`` at 1e-3 and each leaf's change per step
    within relative L2 0.02. Readings: loss up to 6.9e-5, ``grad_norm`` up
    to 1.9e-5 but in the recurrent archs (``GRAD_NORM_RTOL``), changes up
    to 0.0022; ``test_torch_train``'s
    controls read 0.199-1.0 on the change. seamless in bf16 at lr 1e-3: loss, ``grad_norm`` and ``lr``
    at 2e-2, the parameters at bf16 tolerance, the whole change within
    0.25 (``test_torch_train``'s bf16 bound: readings up to 0.123,
    controls 0.40-1.0)."""
    jm, jp, jb, tm, tp, tb = bridged
    bf16 = tm.cfg.name.startswith("seamless")
    if not bf16:
        jp, tp = fp32
    ocfg = dict(lr=1e-3 if bf16 else 1e-2, warmup_steps=1)
    jstep = jax.jit(jbuild_step(jm, JTrainConfig(
        optimizer=JO.AdamWConfig(**ocfg))))
    tstep = build_train_step(tm, TrainConfig(optimizer=O.AdamWConfig(**ocfg)))
    tp = tree_map(torch.clone, tp)
    jopt, topt = JO.init_opt_state(jp), O.init_opt_state(tp)
    start = [_np(t) for t in tree_leaves(tp)]
    for _ in range(3):
        jp, jopt, jm_ = jstep(jp, jopt, jb)
        tp, topt, tm_ = tstep(tp, topt, tb)
        changes = (_changes(tree_leaves(tp), start), _jchanges(jp, start))
        if bf16:
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                           rtol=2e-2)
            for g, w in zip(tree_leaves(tp),
                            jax.tree.leaves(jax.tree.map(np.asarray, jp))):
                np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                           rtol=2e-2, atol=2e-2)
            assert _rel_l2(_flat(changes[0]), _flat(changes[1])) <= 0.25
            continue
        for key, rtol in (("loss", 1e-4), ("grad_norm", GRAD_NORM_RTOL.get(
                tm.cfg.name.removesuffix("-reduced"), 1e-4))):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=rtol)
        for got, want in zip(*changes):
            assert _rel_l2(got, want) <= 0.02
    assert int(topt["count"]) == int(jopt["count"]) == 3


def test_remat_is_bitwise_on_cpu(bridged):
    *_, tm, tp, tb = bridged
    (l1, p1, g1), (l2, p2, g2) = (_port_grads(tm, tp, tb, remat=r)
                                  for r in (True, False))
    assert torch.equal(l1, l2) and p1 == p2
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train CLI against the reference's
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"step +(\d+) loss (\S+) lr (\S+) gnorm (\S+) \d+ms")


@pytest.mark.parametrize("arch", ["dbrx-132b", "xlstm-125m"])
def test_train_cli_matches_reference_cli(arch, capsys):
    """The port's train CLI at ``--reduced`` on the CPU beside the
    reference's on the same flags: the same step lines (steps, learning
    rates to the printed digit), every loss and gradient norm finite and
    each run's loss falling on the seeded stream. (The weights differ: each
    framework's own seed 0.)"""
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    flags = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
             "--lr", "1e-2", "--steps", "6"]
    runs = {}
    for name, fn, extra in (("port", train.main, ["--device", "cpu"]),
                            ("reference", jtrain.main, [])):
        out = fn(flags + extra)
        lines = [STEP_LINE.search(ln) for ln in
                 capsys.readouterr().out.splitlines()]
        runs[name] = ([m.groups() for m in lines if m], out["losses"])
    (port, plosses), (ref, rlosses) = runs["port"], runs["reference"]
    assert len(port) == len(ref) == 6
    assert [(s, lr) for s, _, lr, _ in port] == \
        [(s, lr) for s, _, lr, _ in ref]
    for lines, losses in ((port, plosses), (ref, rlosses)):
        assert np.isfinite(losses).all()
        assert np.isfinite([float(g) for *_, g in lines]).all()
        assert min(losses[3:]) < losses[0], losses
