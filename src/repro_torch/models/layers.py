"""Layer library: attention, dense MLP and MoE (port of
``repro.models.layers``).

Pure functions on tensors; parameters are dicts of tensors described by
TensorSpec trees (see spec.py), in the reference's layouts (``wq [d,h,hd]``,
``wo [h,hd,d]``, experts ``w1 [e,d,f]``). Mamba and xLSTM are not ported
yet (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import TensorSpec

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
    return torch.repeat_interleave(x, virtual // kv, dim=-2)


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, virtual_kv: int):
    """x: [B, S, D] -> q [B,S,H,hd], k/v [B,S,V,hd] (virtual heads, roped)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, _expand_kv(k, virtual_kv), _expand_kv(v, virtual_kv)


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

    q: [B,Sq,H,hd], k/v: [B,Sk,V,hd] with V | H.
    """
    b, sq, h, hd = q.shape
    vheads = k.shape[2]
    g = h // vheads
    qf = q.reshape(b, sq, vheads, g, hd).float()
    s = torch.einsum("bqvgk,bsvk->bvgqs", qf, k.float()) / math.sqrt(hd)
    s = s + _mask_bias(q_pos, k_pos, window, cross)[:, None, None]
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bvgqs,bsvk->bqvgk", pr, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


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
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


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
    h = act(torch.einsum("bsd,df->bsf", x, p["w1"]))
    if cfg.gated_mlp:
        h = h * torch.einsum("bsd,df->bsf", x, p["w3"])
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


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
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = moe_capacity(cfg, s)

    probs, top_p, top_i = route(cfg, p, x)                # [B,S,E], [B,S,k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style), per batch row then averaged
    me = probs.mean(dim=1)                                        # [B,E]
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=1)
    aux = (me * ce).sum(-1).mean() * e

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
    xe = xe.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)

    act = _ACTS[cfg.act]
    h = act(torch.bmm(xe, p["w1"]))
    if cfg.gated_mlp:
        h = h * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"]).reshape(e, b, cap, d).transpose(0, 1)

    # combine: each entry's place in its expert (from the sorted order
    # back to (token, choice)), its expert slot or the zero trash row
    rank = torch.arange(s * k, device=x.device) - torch.gather(
        seg_start, 1, sorted_e)
    pos = torch.empty_like(rank).scatter_(1, order, rank).reshape(b, s, k)
    keep = pos < cap
    dest = torch.where(keep, top_i * cap + pos, e * cap)
    yflat = torch.cat([ye.reshape(b, e * cap, d),
                       torch.zeros((b, 1, d), dtype=ye.dtype,
                                   device=x.device)], dim=1)
    w = (top_p * keep.to(top_p.dtype)).to(ye.dtype)
    contrib = torch.gather(yflat, 1, dest.reshape(b, s * k, 1)
                           .expand(b, s * k, d)).reshape(b, s, k, d)
    contrib = contrib * w[..., None]
    by_id = torch.argsort(top_i, dim=-1)                          # [B,S,k]
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=x.device)
    for j in range(k):
        y = y + torch.gather(
            contrib, 2, by_id[..., j, None, None].expand(b, s, 1, d))[:, :, 0]
    return y, aux
