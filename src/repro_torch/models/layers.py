"""Layer library: norms, RoPE, attention, MLP, MoE, Mamba, xLSTM (port of
``repro.models.layers``).

Pure functions on tensors; parameters are dicts of tensors described by
TensorSpec trees (see spec.py), in the reference's layouts (``wq [d,h,hd]``,
``wo [h,hd,d]``, experts ``w1 [e,d,f]``, Mamba ``w_in [d,2*di]``).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import MambaConfig, ModelConfig, XLSTMConfig
from repro_torch.kernels import _build
from repro_torch.models.spec import TensorSpec
from repro_torch.sharding.rules import shard

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": TensorSpec((d,), (None,), init="ones"),
                "bias": TensorSpec((d,), (None,), init="zeros")}
    return {"scale": TensorSpec((d,), (None,), init="ones")}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int32)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)          # fp32, no host->device scalar
    ang = positions[..., None].float() * freq          # [..., seq, half]
    cos = torch.cos(ang)[..., None, :]                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attn_spec(cfg: ModelConfig) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    spec: Params = {
        "wq": TensorSpec((d, h, hd), ("fsdp", "heads", "head_dim")),
        "wk": TensorSpec((d, kv, hd), ("fsdp", "kv", "head_dim")),
        "wv": TensorSpec((d, kv, hd), ("fsdp", "kv", "head_dim")),
        "wo": TensorSpec((h, hd, d), ("heads", "head_dim", "fsdp"),
                         fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        spec["bq"] = TensorSpec((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = TensorSpec((kv, hd), ("kv", "head_dim"), init="zeros")
        spec["bv"] = TensorSpec((kv, hd), ("kv", "head_dim"), init="zeros")
    return spec


def _expand_kv(x: torch.Tensor, virtual: int) -> torch.Tensor:
    """[..., kv, hd] -> [..., virtual, hd] by repetition (vLLM-style)."""
    kv = x.shape[-2]
    if virtual == kv:
        return x
    if isinstance(x, DTensor):
        # on each rank's shard with the heads whole: DTensor cannot split
        # the gradient of a head-sharded repeat back into its groups
        pl = tuple(Replicate() if p == Shard(x.ndim - 2)
                   or isinstance(p, Partial) else p for p in x.placements)
        return local_map(lambda t: torch.repeat_interleave(
            t, virtual // kv, dim=-2), out_placements=(pl,),
            in_placements=(pl,), redistribute_inputs=True,
            device_mesh=x.device_mesh)(x)
    return torch.repeat_interleave(x, virtual // kv, dim=-2)


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, virtual_kv: int):
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,V,hd] (virtual heads, roped)."""
    q = torch.einsum("bsd,dhk->bshk", x,
                     gathered(p["wq"], "fsdp", "heads", "head_dim"))
    k = torch.einsum("bsd,dhk->bshk", x,
                     gathered(p["wk"], "fsdp", "kv", "head_dim"))
    v = torch.einsum("bsd,dhk->bshk", x,
                     gathered(p["wv"], "fsdp", "kv", "head_dim"))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(k, virtual_kv)
    v = _expand_kv(v, virtual_kv)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv", None)
    v = shard(v, "batch", None, "kv", None)
    return q, k, v


def _mask_bias(q_pos, k_pos, window: int, cross: bool) -> torch.Tensor:
    """Additive mask bias: 0 where visible, -inf where masked.

    q_pos: [..., Sq], k_pos: [..., Sk] (absolute positions; -1 = invalid slot).
    """
    valid = k_pos[..., None, :] >= 0
    if not cross:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., None])
        if window > 0:
            valid = valid & (q_pos[..., None] - k_pos[..., None, :] < window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, -math.inf))


def attn_reference(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                   window: int = 0, cross: bool = False) -> torch.Tensor:
    """Dense softmax attention (oracle / small shapes).

    q: [B,Sq,H,hd], k/v: [B,Sk,V,hd] with V | H. DTensors whose keys are
    whole along the sequence attend on each rank's rows and heads
    (``_attn_rows_heads``).
    """
    if isinstance(q, DTensor) and isinstance(k, DTensor) \
            and Shard(1) not in k.placements:
        return _attn_rows_heads(cfg, q, k, v, q_pos, k_pos, window, cross)
    b, sq, h, hd = q.shape
    vheads = k.shape[2]
    g = h // vheads
    qf = q.reshape(b, sq, vheads, g, hd).float()
    s = torch.einsum("bqvgk,bsvk->bvgqs", qf, k.float()) / math.sqrt(hd)
    s = s + _mask_bias(q_pos, k_pos, window, cross)[:, None, None]
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bvgqs,bsvk->bqvgk", pr, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def gathered(w: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Weight ``w`` (logical axes ``logical``) with its "fsdp" dims
    gathered before use, FSDP's all-gather: ``shard`` to its axes less
    "fsdp". The train step reduce-scatters its gradient back to the
    parameter's placement (``constrain_grads_like_params``). A no-op
    outside a sharding context and wherever no fsdp dim is sharded."""
    return shard(w, *(None if a == "fsdp" else a for a in logical))


def _attn_rows_heads(cfg, q, k, v, q_pos, k_pos, window, cross):
    """``attn_reference`` of DTensors on each rank's batch rows and heads:
    a mesh dim keeps a shard that q, k and v all have on dim 0 (batch; the
    positions too) or dim 2 (query and KV heads split alike keep each
    group on its rank); every other mesh dim is replicated first. The
    arithmetic per row and head is the one-device arithmetic, where
    DTensor's own batched product cannot take the batch and head shards
    merged into one dim."""
    rows_ok = all(isinstance(t, DTensor) for t in (q_pos, k_pos))
    keep = []
    for i in range(q.device_mesh.ndim):
        pls = {q.placements[i], k.placements[i], v.placements[i]}
        pl = pls.pop() if len(pls) == 1 else None
        keep.append(pl if pl == Shard(2) or (pl == Shard(0) and rows_ok)
                    else Replicate())
    keep = tuple(keep)
    pos_pl = tuple(pl if pl == Shard(0) else Replicate() for pl in keep)
    in_pl = (keep, keep, keep) + tuple(
        pos_pl if isinstance(t, DTensor) else None for t in (q_pos, k_pos))
    return local_map(
        lambda *a: attn_reference(cfg, *a, window=window, cross=cross),
        out_placements=(keep,), in_placements=in_pl,
        redistribute_inputs=True, device_mesh=q.device_mesh)(
        q, k, v, q_pos, k_pos)


def attn_chunked(cfg: ModelConfig, q, k, v, q_pos, k_pos,
                 window: int = 0, cross: bool = False,
                 chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention scanning KV in chunks (the reference's jnp
    twin of the flash kernel, kept as a plain function for the tests; the
    port's prefill runs the flash kernel instead)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    vheads = k.shape[2]
    g = h // vheads
    chunk = min(chunk, sk)
    nc = (sk + chunk - 1) // chunk
    pad = nc * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    qf = q.reshape(b, sq, vheads, g, hd) / math.sqrt(hd)
    m = torch.full((b, vheads, g, sq), -math.inf, device=q.device)
    l = torch.zeros((b, vheads, g, sq), device=q.device)
    acc = torch.zeros((b, vheads, g, sq, hd), device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqvgk,bsvk->bvgqs", qf.float(), k[:, sl].float())
        s = s + _mask_bias(q_pos, k_pos[:, sl], window, cross)[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        pexp = torch.exp(s - m_safe[..., None])
        scale = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                      torch.full_like(m, -math.inf)))
        l = l * scale + pexp.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bvgqs,bsvk->bvgqk", pexp, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def attn_out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    y = torch.einsum("bshk,hkd->bsd", o,
                     gathered(p["wo"], "heads", "head_dim", "fsdp"))
    return shard(y, "batch", None, None)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_spec(cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    spec = {
        "w1": TensorSpec((d, f), ("fsdp", "mlp")),
        "w2": TensorSpec((f, d), ("mlp", "fsdp")),
    }
    if cfg.gated_mlp:
        spec["w3"] = TensorSpec((d, f), ("fsdp", "mlp"))
    return spec


def moe_spec(cfg: ModelConfig) -> Params:
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    spec = {
        "router": TensorSpec((d, e), ("fsdp", None)),
        "w1": TensorSpec((e, d, f), ("experts", "fsdp", "expert_mlp"), fan_in_axes=(1,)),
        "w2": TensorSpec((e, f, d), ("experts", "expert_mlp", "fsdp"), fan_in_axes=(1,)),
    }
    if cfg.gated_mlp:
        spec["w3"] = TensorSpec((e, d, f), ("experts", "fsdp", "expert_mlp"),
                                fan_in_axes=(1,))
    return spec


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    act = _ACTS[cfg.act]
    h = act(torch.einsum("bsd,df->bsf", x, gathered(p["w1"], "fsdp", "mlp")))
    if cfg.gated_mlp:
        h = h * torch.einsum("bsd,df->bsf", x,
                             gathered(p["w3"], "fsdp", "mlp"))
    h = shard(h, "batch", None, "mlp")
    y = torch.einsum("bsf,fd->bsd", h, gathered(p["w2"], "mlp", "fsdp"))
    return shard(y, "batch", None, None)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, per-row capacity dispatch)
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    m = cfg.moe
    assert m is not None
    return max(1, int(math.ceil(seq * m.top_k / m.num_experts * m.capacity_factor)))


def route(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The router of ``apply_moe``: the fp32 softmax over experts [B, S, E]
    of ``x`` [B, S, D] times ``p["router"]`` [D, E] (products of the
    inputs exact in fp32), and each token's top k [B, S, k] probabilities
    and expert ids in descending probability, the lower id first on ties
    (``lax.top_k``'s order, from a stable sort)."""
    probs = torch.softmax(
        torch.einsum("bsd,de->bse", x.float(), p["router"].float()), dim=-1)
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    k = cfg.moe.top_k
    return probs, sorted_p[..., :k], sorted_i[..., :k]


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: [B, S, D]. Dispatch is per batch row, with the reference's
    semantics: fp32 router softmax, top-k in descending probability with
    the lower expert id first on ties, weights renormalised (1e-9 floor),
    each expert taking its first ``cap`` tokens in (token, choice) order
    and dropping the rest. Every expert computes its ``cap`` slots (at
    decode, cap 1: all experts, mostly against zero rows). A token's k
    contributions are added to a zero row in increasing expert id, in the
    activation dtype, the order of the reference's sorted scatter-add; no
    atomics, so the result does not depend on the launch.

    Returns (y, aux_loss)."""
    m = cfg.moe
    assert m is not None
    e = m.num_experts
    if isinstance(x, DTensor):
        # routing, dispatch and combine are per batch row: each rank runs
        # them on its own rows (``_on_rows``); the experts' products stay
        # DTensors
        xe, aux_rows, *meta = _on_rows(
            lambda xl, rl: _moe_dispatch(cfg, rl, xl),
            (x, gathered(p["router"], "fsdp", None)), 6, (0,))
    else:
        xe, aux_rows, *meta = _moe_dispatch(cfg, p["router"], x)
    aux = aux_rows.mean() * e
    b, _, cap, d = xe.shape
    # "moe_batch" == "batch" for train/prefill; replicated at decode so
    # the 2D-sharded expert weights stay put and only tokens move
    xe = shard(xe, "moe_batch", "experts", None, None)
    xe = xe.transpose(0, 1).reshape(e, b * cap, d)

    act = _ACTS[cfg.act]
    h = act(torch.bmm(xe, gathered(p["w1"], "experts", "fsdp",
                                   "expert_mlp")))
    if cfg.gated_mlp:
        h = h * torch.bmm(xe, gathered(p["w3"], "experts", "fsdp",
                                       "expert_mlp"))
    f = h.shape[-1]
    h = shard(h.reshape(e, b, cap, f), "experts", "moe_batch", None,
              "expert_mlp").reshape(e, b * cap, f)
    ye = torch.bmm(h, gathered(p["w2"], "experts", "expert_mlp", "fsdp"))
    ye = ye.reshape(e, b, cap, d).transpose(0, 1)
    ye = shard(ye, "moe_batch", "experts", None, None)
    if isinstance(x, DTensor):
        y = _on_rows(lambda yl, *ml: _moe_combine(cfg, yl, *ml),
                     (ye, *meta), 1, range(5))
    else:
        y = _moe_combine(cfg, ye, *meta)
    return shard(y, "batch", None, None), aux


def _moe_dispatch(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """Route and dispatch ``x`` [B, S, D]: (xe [B, E, cap, D], each row's
    aux-loss term [B], and what the combine needs: the renormalised top-k
    weights and ids [B, S, k], each entry's place in its expert [B, S, k]
    and whether it fits, ``keep``)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = moe_capacity(cfg, s)

    probs, top_p, top_i = route(cfg, {"router": router}, x)  # [B,S,E], [B,S,k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style), per batch row
    me = probs.mean(dim=1)                                        # [B,E]
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=1)
    aux_rows = (me * ce).sum(-1)

    # dispatch: a stable sort of the (token, choice) entries by expert; an
    # entry's place among its expert's entries decides whether it fits
    flat_e = top_i.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device).expand(b, e).contiguous())
    seg_end = torch.cat([seg_start[:, 1:], torch.full(
        (b, 1), s * k, dtype=seg_start.dtype, device=x.device)], dim=1)
    # expert slot (e, c) holds the entry at seg_start[e] + c, if any
    slot = seg_start[:, :, None] + torch.arange(cap, device=x.device)
    filled = slot < seg_end[:, :, None]                           # [B,E,cap]
    src_tok = torch.gather(order, 1, slot.clamp(max=s * k - 1)
                           .reshape(b, e * cap)) // k
    xe = torch.gather(x, 1, src_tok[..., None].expand(b, e * cap, d))
    xe = torch.where(filled.reshape(b, e * cap, 1), xe,
                     torch.zeros((), dtype=x.dtype, device=x.device))

    # each entry's place in its expert (from the sorted order back to
    # (token, choice))
    rank = torch.arange(s * k, device=x.device) - torch.gather(
        seg_start, 1, sorted_e)
    pos = torch.empty_like(rank).scatter_(1, order, rank).reshape(b, s, k)
    keep = pos < cap
    return xe.reshape(b, e, cap, d), aux_rows, top_p, top_i, pos, keep


def _moe_combine(cfg: ModelConfig, ye: torch.Tensor, top_p: torch.Tensor,
                 top_i: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor):
    """Combine the experts' outputs ``ye`` [B, E, cap, D] back to tokens:
    each entry's expert slot or the zero trash row, weighted, added to a
    zero row in increasing expert id."""
    b, e, cap, d = ye.shape
    s, k = top_i.shape[1], top_i.shape[2]
    dest = torch.where(keep, top_i * cap + pos, e * cap)
    yflat = torch.cat([ye.reshape(b, e * cap, d),
                       torch.zeros((b, 1, d), dtype=ye.dtype,
                                   device=ye.device)], dim=1)
    w = (top_p * keep.to(top_p.dtype)).to(ye.dtype)
    contrib = torch.gather(yflat, 1, dest.reshape(b, s * k, 1)
                           .expand(b, s * k, d)).reshape(b, s, k, d)
    contrib = contrib * w[..., None]
    by_id = torch.argsort(top_i, dim=-1)                          # [B,S,k]
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + torch.gather(
            contrib, 2, by_id[..., j, None, None].expand(b, s, 1, d))[:, :, 0]
    return y


def _on_rows(fn, args: tuple, n_out: int, batch_args):
    """``fn`` on each rank's batch rows of DTensor ``args``: the arguments
    at ``batch_args`` keep their batch (dim 0) shards and are replicated on
    every other mesh dim; the rest are replicated whole. Its ``n_out``
    outputs are row-sharded alike (one DTensor, or a tuple)."""
    batch_args = tuple(batch_args)
    lead = args[batch_args[0]]
    rows = tuple(pl if pl == Shard(0) else Replicate()
                 for pl in lead.placements)
    whole = tuple(Replicate() for _ in rows)
    # a whole argument's gradient from each rank's rows is that rank's part
    # of the sum over the rows' mesh dims
    whole_grad = tuple(Partial() if pl == Shard(0) else Replicate()
                       for pl in rows)
    return local_map(fn, out_placements=(rows,) * n_out,
                     in_placements=tuple(rows if i in batch_args else whole
                                         for i in range(len(args))),
                     in_grad_placements=tuple(
                         rows if i in batch_args else whole_grad
                         for i in range(len(args))),
                     redistribute_inputs=True,
                     device_mesh=lead.device_mesh)(*args)


# ---------------------------------------------------------------------------
# Mamba (selective SSM, Mamba-1 style with chunked parallel scan)
# ---------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    mc = cfg.mamba or MambaConfig()
    di = mc.expand * cfg.d_model
    dtr = max(1, cfg.d_model // 16)
    return di, mc.d_state, mc.d_conv, dtr


def mamba_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di, ds, dc, dtr = _mamba_dims(cfg)
    return {
        "w_in": TensorSpec((d, 2 * di), ("fsdp", "mlp")),
        "conv_w": TensorSpec((dc, di), ("conv", "mlp")),
        "conv_b": TensorSpec((di,), ("mlp",), init="zeros"),
        "w_x": TensorSpec((di, dtr + 2 * ds), ("mlp", None)),
        "w_dt": TensorSpec((dtr, di), (None, "mlp")),
        "dt_bias": TensorSpec((di,), ("mlp",), init="zeros"),
        "a_log": TensorSpec((di, ds), ("mlp", None), init="zeros"),
        "d_skip": TensorSpec((di,), ("mlp",), init="ones"),
        "w_out": TensorSpec((di, d), ("mlp", "fsdp")),
    }


def _mamba_gates(cfg: ModelConfig, p: Params, xz: torch.Tensor):
    """The input projection. xz: [B,S,D] -> (x_in, z), each [B,S,di]."""
    proj = torch.einsum("bsd,de->bse", xz, gathered(p["w_in"], "fsdp", "mlp"))
    x_in, z = proj.chunk(2, dim=-1)
    return x_in, z


def _causal_conv(x_in: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv. x_in [B,S,di], w [dc,di]. state [B,dc-1,di].
    Taps are summed in the reference's order, in the input's dtype."""
    dc = w.shape[0]
    if state is None:
        pad = torch.zeros((x_in.shape[0], dc - 1, x_in.shape[2]),
                          dtype=x_in.dtype, device=x_in.device)
    else:
        pad = state.to(x_in.dtype)
    xp = torch.cat([pad, x_in], dim=1)              # [B, S+dc-1, di]
    s = x_in.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(dc))
    new_state = xp[:, xp.shape[1] - (dc - 1):, :] if dc > 1 else pad[:, :0]
    return out + b, new_state


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Merge along dim 1: even[0], odd[0], even[1], ... (len(even) is
    len(odd) or one more)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1)


def associative_scan(combine, elems: tuple[torch.Tensor, ...]):
    """Inclusive scan along dim 1 with ``jax.lax.associative_scan``'s
    combination tree (pairs reduced, the odd prefix scanned recursively,
    the even prefix filled in): log-depth, and each element is combined in
    the reference's order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine(tuple(e[:, 0:n - 1:2] for e in elems),
                      tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(o[:, :-1] for o in odd),
                       tuple(e[:, 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _ssm_combine(lhs, rhs):
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, b1 * a2 + b2


def _ssm_scan(dt, u, bmat, cmat, a, chunk: int):
    """The selective scan of ``apply_mamba_seq``: (y [B,S,di], final state
    [B,di,ds]) from dt, u [B,S,di], B, C [B,S,ds] and A [di,ds], all fp32."""
    b, s, di = u.shape
    ds = a.shape[1]
    chunk = min(chunk, s)
    nc = (s + chunk - 1) // chunk
    pad = nc * chunk - s
    if pad:
        dt, u, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                             for t in (dt, u, bmat, cmat))

    h = torch.zeros((b, di, ds), dtype=torch.float32, device=u.device)
    if _build.is_fake(u):
        # a traced stand-in: one chunk counted for all nc
        body = lambda dt, u, bmat, cmat, a, h: _ssm_chunk(
            dt[:, :chunk], u[:, :chunk], bmat[:, :chunk], cmat[:, :chunk],
            a, h)
        return _OneTrip.apply(body, nc, ((b, s, di), (b, di, ds)), dt, u,
                              bmat, cmat, a, h)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, h = _ssm_chunk(dt[:, sl], u[:, sl], bmat[:, sl], cmat[:, sl], a, h)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def _ssm_chunk(dt, u, bmat, cmat, a, h):
    """One chunk of ``_ssm_scan``: within it an associative (log-step) scan
    materializes h per position ([B,Q,di,ds]) from the carry ``h``."""
    decay = torch.exp(dt[:, :, :, None] * a)                  # [B,Q,di,ds]
    inp = u[:, :, :, None] * bmat[:, :, None, :]               # [B,Q,di,ds]
    dec_cum, h_all = associative_scan(_ssm_combine, (decay, inp))
    h_all = h_all + dec_cum * h[:, None]                       # carry-in
    return torch.einsum("bqis,bqs->bqi", h_all, cmat), h_all[:, -1]


class _OneTrip(torch.autograd.Function):
    """On fake tensors (the dry run), a loop of ``n`` identical trips:
    ``body`` (one trip of the inputs) runs once forward and once backward,
    each counted ``n`` times (``_build.repeated``), and the outputs are
    fake tensors of the whole loop's ``shapes``: the reference's trip-count
    weighting, where tracing every trip of a long scan would take hours.
    The backward re-runs the trip uncounted to differentiate it, so no
    tensor of the trip is saved (a saved tensor under remat would replay
    the whole layer inside the trip's count)."""

    @staticmethod
    def forward(ctx, body, n, shapes, *xs):
        with _build.repeated(n):
            outs = body(*xs)
        ctx.body, ctx.n, ctx.xs = body, n, xs
        return tuple(torch.empty(s, dtype=o.dtype, device=o.device)
                     for s, o in zip(shapes, outs))

    @staticmethod
    def backward(ctx, *grads):
        ins = [x.detach().requires_grad_(x.requires_grad) for x in ctx.xs]
        need = [x for x in ins if x.requires_grad]
        got = ()
        with torch.enable_grad():
            with _build.repeated(0):
                outs = [o for o in ctx.body(*ins) if o.requires_grad]
            if need and outs:
                with _build.repeated(ctx.n):
                    got = torch.autograd.grad(
                        outs, need, [torch.ones_like(o) for o in outs],
                        allow_unused=True)
        got = iter(got)
        return (None, None, None, *(next(got) if x.requires_grad else None
                                    for x in ins))


def _ssm_scan_shards(scan, dt, u, bmat, cmat, a):
    """``_ssm_scan`` of DTensors on each rank's batch rows and inner
    channels (the scan runs per row and per channel): a mesh dim keeps u's
    shard of dim 0 or dim 2 (di), every other mesh dim is replicated."""
    R = Replicate()
    chan, bc, a_pl, h_pl, bc_grad, a_grad = [], [], [], [], [], []
    for pl in u.placements:
        rows, inner = pl == Shard(0), pl == Shard(2)
        chan.append(pl if rows or inner else R)
        bc.append(pl if rows else R)
        a_pl.append(Shard(0) if inner else R)
        h_pl.append(Shard(1) if inner else (pl if rows else R))
        # B and C feed every channel and A every row: each rank's gradient
        # is its part of the sum over the channels' or rows' mesh dims
        bc_grad.append(Partial() if inner else bc[-1])
        a_grad.append(Partial() if rows else a_pl[-1])
    chan, bc, a_pl, h_pl, bc_grad, a_grad = map(
        tuple, (chan, bc, a_pl, h_pl, bc_grad, a_grad))
    return local_map(scan, out_placements=(chan, h_pl),
                     in_placements=(chan, chan, bc, bc, a_pl),
                     in_grad_placements=(chan, chan, bc_grad, bc_grad,
                                         a_grad),
                     redistribute_inputs=True,
                     device_mesh=u.device_mesh)(dt, u, bmat, cmat, a)


def apply_mamba_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    chunk: int = 32):
    """Full-sequence selective scan (prefill). Returns (y, final_state).

    Chunked, in fp32: within a chunk, an associative (log-step) scan
    materializes h per position ([B,Q,di,ds]); across chunks a loop carries
    h."""
    b, s, d = x.shape
    di, ds, dc, dtr = _mamba_dims(cfg)
    x_in, z = _mamba_gates(cfg, p, x)
    x_conv, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"], None)
    x_conv = F.silu(x_conv)
    # reduced over the inner dim before it is split three ways: DTensor
    # cannot carry the pending sum through the split into w_dt's product
    xdb = shard(torch.einsum("bsi,ie->bse", x_conv, p["w_x"]),
                "batch", None, None)
    dt_raw, bmat, cmat = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.einsum("bsr,ri->bsi", dt_raw, p["w_dt"])
                    + p["dt_bias"]).float()                   # [B,S,di]
    a = -torch.exp(p["a_log"].float())                         # [di,ds]
    u = dt * x_conv.float()                                    # [B,S,di]
    bmat, cmat = bmat.float(), cmat.float()

    scan = lambda *t: _ssm_scan(*t, chunk=chunk)
    if isinstance(u, DTensor):
        y, h = _ssm_scan_shards(scan, dt, u, bmat, cmat, a)
    else:
        y, h = scan(dt, u, bmat, cmat, a)
    y = y + p["d_skip"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.einsum("bsi,id->bsd", y, gathered(p["w_out"], "mlp", "fsdp"))
    return shard(out, "batch", None, None), {"conv": conv_state, "ssm": h}


def apply_mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       cache: Params):
    """Single-token step. x: [B,1,D]; cache {conv [B,dc-1,di], ssm [B,di,ds]}."""
    di, ds, dc, dtr = _mamba_dims(cfg)
    x_in, z = _mamba_gates(cfg, p, x)
    x_conv, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                      cache["conv"])
    x_conv = F.silu(x_conv)
    xdb = torch.einsum("bsi,ie->bse", x_conv, p["w_x"])
    dt_raw, bmat, cmat = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.einsum("bsr,ri->bsi", dt_raw, p["w_dt"])
                    + p["dt_bias"]).float()[:, 0]             # [B,di]
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt[..., None] * a)                       # [B,di,ds]
    u = dt * x_conv[:, 0].float()                              # [B,di]
    h = cache["ssm"] * decay + u[..., None] * bmat[:, 0, None, :].float()
    y = torch.einsum("bis,bs->bi", h, cmat[:, 0].float())
    y = y + p["d_skip"].float() * x_conv[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = torch.einsum("bi,id->bd", y,
                       gathered(p["w_out"], "mlp", "fsdp"))[:, None]
    return shard(out, "batch", None, None), {"conv": conv_state, "ssm": h}


def mamba_cache_spec(cfg: ModelConfig, batch: int) -> Params:
    di, ds, dc, _ = _mamba_dims(cfg)
    return {
        "conv": TensorSpec((batch, dc - 1, di), ("batch", None, "mlp"),
                           dtype=torch.bfloat16, init="zeros"),
        "ssm": TensorSpec((batch, di, ds), ("batch", "mlp", None),
                          dtype=torch.float32, init="zeros"),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory), sequential loops
# over positions, as the reference's lax.scan
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    h = cfg.num_heads
    xc = cfg.xlstm or XLSTMConfig()
    di = int(xc.proj_factor_mlstm * cfg.d_model)
    return h, di, di // h


def mlstm_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    h, di, dh = _mlstm_dims(cfg)
    return {
        "w_up": TensorSpec((d, 2 * di), ("fsdp", "mlp")),
        "wq": TensorSpec((di, h, dh), ("mlp", "heads", None)),
        "wk": TensorSpec((di, h, dh), ("mlp", "heads", None)),
        "wv": TensorSpec((di, h, dh), ("mlp", "heads", None)),
        "w_gates": TensorSpec((di, 2 * h), ("mlp", None)),  # i, f pre-acts
        "w_down": TensorSpec((di, d), ("mlp", "fsdp")),
    }


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, elementwise on each local shard
    (DTensor has no sharding rule for it)."""
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in x.placements)
    return local_map(F.logsigmoid, out_placements=(pl,), in_placements=(pl,),
                     redistribute_inputs=True, device_mesh=x.device_mesh)(x)


def _mlstm_step(q, k, v, i_pre, f_pre, state):
    """One mLSTM step (stabilized exponential gating, fp32).

    q/k/v: [B,H,dh]; i_pre/f_pre: [B,H]; state: dict(C [B,H,dh,dh],
    n [B,H,dh], m [B,H]).
    """
    logf = _logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fgate = torch.exp(logf + state["m"] - m_new)
    igate = torch.exp(i_pre - m_new)
    c = state["C"] * fgate[..., None, None] + \
        igate[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = state["n"] * fgate[..., None] + igate[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", n, q).abs(), min=1.0)
    return num / den[..., None], {"C": c, "n": n, "m": m_new}


def _mlstm_inputs(p: Params, xi: torch.Tensor, dh: int):
    """q, k (scaled by 1/sqrt(dh) in the activation dtype), v and the gate
    pre-activations, in fp32, from the up-projected input [..., di]."""
    q = torch.einsum("...i,ihk->...hk", xi, p["wq"]).float()
    k = (torch.einsum("...i,ihk->...hk", xi, p["wk"])
         / math.sqrt(dh)).float()
    v = torch.einsum("...i,ihk->...hk", xi, p["wv"]).float()
    gates = torch.einsum("...i,ig->...g", xi, p["w_gates"]).float()
    i_pre, f_pre = gates.chunk(2, dim=-1)
    return q, k, v, i_pre, f_pre


def _mlstm_scan(q, k, v, i_pre, f_pre):
    """The mLSTM recurrence over the sequence: (outputs [B,S,H*dh], and
    the final C, n, m)."""
    b, s, h, dh = q.shape
    state = {
        "C": torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device),
        "n": torch.zeros((b, h, dh), dtype=torch.float32, device=q.device),
        "m": torch.zeros((b, h), dtype=torch.float32, device=q.device),
    }
    if _build.is_fake(q):
        # a traced stand-in: one step counted for all s
        def body(q, k, v, i_pre, f_pre, c, n, m):
            yt, st = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                                 f_pre[:, 0], {"C": c, "n": n, "m": m})
            return yt, st["C"], st["n"], st["m"]
        shapes = ((b, s, h * dh), (b, h, dh, dh), (b, h, dh), (b, h))
        return _OneTrip.apply(body, s, shapes, q, k, v, i_pre, f_pre,
                              state["C"], state["n"], state["m"])
    ys = []
    for t in range(q.shape[1]):
        yt, state = _mlstm_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                f_pre[:, t], state)
        ys.append(yt)
    return (torch.stack(ys, dim=1).reshape(b, q.shape[1], h * dh),
            state["C"], state["n"], state["m"])


def apply_mlstm_seq(cfg: ModelConfig, p: Params, x: torch.Tensor):
    b, s, d = x.shape
    h, di, dh = _mlstm_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, gathered(p["w_up"], "fsdp", "mlp"))
    xi, z = up.chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_inputs(p, xi, dh)
    args = (q, k, v, i_pre, f_pre)
    ys, *st = _on_rows(_mlstm_scan, args, 4, range(5)) \
        if isinstance(q, DTensor) else _mlstm_scan(*args)
    state = dict(zip(("C", "n", "m"), st))
    y = ys.to(x.dtype)
    # held to the rules' layout (rows, inner dim): DTensor would otherwise
    # split the sequence where it split the gate's halves
    y = shard(y * F.silu(z), "batch", None, "mlp")
    out = torch.einsum("bsi,id->bsd", y, gathered(p["w_down"], "mlp", "fsdp"))
    # every mixer's output in the residual layout, as the reference holds
    # attention's and Mamba's (the constraint also holds its gradient)
    return shard(out, "batch", None, None), state


def apply_mlstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       cache: Params):
    b = x.shape[0]
    h, di, dh = _mlstm_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, gathered(p["w_up"], "fsdp", "mlp"))
    xi, z = up.chunk(2, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_inputs(p, xi[:, 0], dh)
    y, state = _mlstm_step(q, k, v, i_pre, f_pre, cache)
    y = y.reshape(b, 1, di).to(x.dtype) * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, gathered(p["w_down"], "mlp",
                                                   "fsdp")), state


def mlstm_cache_spec(cfg: ModelConfig, batch: int) -> Params:
    h, di, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": TensorSpec((batch, h, dh, dh), ("batch", "heads", None, None),
                        dtype=f32, init="zeros"),
        "n": TensorSpec((batch, h, dh), ("batch", "heads", None),
                        dtype=f32, init="zeros"),
        "m": TensorSpec((batch, h), ("batch", "heads"), dtype=f32,
                        init="zeros"),
    }


def slstm_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    return {
        "w_x": TensorSpec((d, 4 * d), ("fsdp", "mlp")),   # i,f,z,o from input
        "w_h": TensorSpec((d, 4 * d), (None, "mlp")),     # recurrent
        "b": TensorSpec((4 * d,), ("mlp",), init="zeros"),
    }


def _slstm_step(pre, state):
    """pre: [B,4D] (input plus recurrent contribution, fp32); state: c, n,
    h, m each [B,D]."""
    it, ft, zt, ot = pre.chunk(4, dim=-1)
    logf = _logsigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    ig = torch.exp(it - m_new)
    fg = torch.exp(logf + state["m"] - m_new)
    c = fg * state["c"] + ig * torch.tanh(zt)
    n = fg * state["n"] + ig
    hh = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return hh, {"c": c, "n": n, "h": hh, "m": m_new}


def apply_slstm_seq(cfg: ModelConfig, p: Params, x: torch.Tensor):
    b, s, d = x.shape
    xpre = torch.einsum("bsd,de->bse", x,
                        gathered(p["w_x"], "fsdp", "mlp")) + p["b"]
    w_h = p["w_h"].float()
    ys, *st = _on_rows(_slstm_scan, (xpre, w_h), 5, (0,)) \
        if isinstance(xpre, DTensor) else _slstm_scan(xpre, w_h)
    return (shard(ys.to(x.dtype), "batch", None, None),
            dict(zip(("c", "n", "h", "m"), st)))


def _slstm_scan(xpre, w_h):
    """The sLSTM recurrence over the sequence: (outputs [B,S,D], and the
    final c, n, h, m)."""
    b, s, d = xpre.shape[0], xpre.shape[1], w_h.shape[0]
    state = {k: torch.zeros((b, d), dtype=torch.float32, device=xpre.device)
             for k in ("c", "n", "h", "m")}
    if _build.is_fake(xpre):
        # a traced stand-in: one step counted for all s
        def body(xpre, w_h, *st):
            pre = xpre[:, 0].float() + torch.einsum("bd,de->be", st[2], w_h)
            hh, new = _slstm_step(pre, dict(zip(("c", "n", "h", "m"), st)))
            return (hh, new["c"], new["n"], new["h"], new["m"])
        return _OneTrip.apply(body, s, ((b, s, d),) + ((b, d),) * 4, xpre,
                              w_h, *(state[k] for k in ("c", "n", "h", "m")))
    ys = []
    for t in range(s):
        pre = xpre[:, t].float() + torch.einsum("bd,de->be", state["h"], w_h)
        hh, state = _slstm_step(pre, state)
        ys.append(hh)
    return (torch.stack(ys, dim=1), state["c"], state["n"], state["h"],
            state["m"])


def apply_slstm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       cache: Params):
    xpre = torch.einsum("bd,de->be", x[:, 0],
                        gathered(p["w_x"], "fsdp", "mlp")) + p["b"]
    pre = xpre.float() + torch.einsum("bd,de->be", cache["h"],
                                      p["w_h"].float())
    hh, state = _slstm_step(pre, cache)
    return hh[:, None].to(x.dtype), state


def slstm_cache_spec(cfg: ModelConfig, batch: int) -> Params:
    d = cfg.d_model
    return {k: TensorSpec((batch, d), ("batch", None), dtype=torch.float32,
                          init="zeros") for k in ("c", "n", "h", "m")}
