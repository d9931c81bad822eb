"""Transformer stack assembly (port of ``repro.models.transformer``):
attention, Mamba, mLSTM and sLSTM mixers, dense or MoE MLPs, and the
encoder with the decoder's cross attention.

The layer stack is organized by the config's repeating *pattern* of P block
kinds (P=1 for homogeneous models, 8 for jamba, 2 for xlstm); parameters
for pattern position j are stacked over the R = num_layers / P repetitions
(``[R, ...]`` leaves, as in the reference). The reference's ``lax.scan``
over R becomes a Python loop over units — the same scan unit the memory
manager re-groups into offloading intervals.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.spec import (TensorSpec, tree_leaves, tree_map,
                                     tree_map_spec)

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


_MIXER_SPECS = {"attention": L.attn_spec, "mamba": L.mamba_spec,
                "mlstm": L.mlstm_spec, "slstm": L.slstm_spec}


def block_spec(cfg: ModelConfig, blk: BlockSpec, cross: bool = False) -> Params:
    spec: Params = {"norm1": L.norm_spec(cfg),
                    "attn": _MIXER_SPECS[blk.mixer](cfg)}
    if cross:
        spec["norm_cross"] = L.norm_spec(cfg)
        spec["cross"] = L.attn_spec(cfg)
    if cfg.d_ff > 0:
        spec["norm2"] = L.norm_spec(cfg)
        spec["mlp"] = L.moe_spec(cfg) if blk.mlp == "moe" else L.mlp_spec(cfg)
    return spec


def pattern_info(cfg: ModelConfig) -> tuple[int, int]:
    """(P, R): pattern length and repetitions. num_layers must be P*R."""
    p = len(cfg.pattern)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p, cfg.num_layers // p


def decoder_stack_spec(cfg: ModelConfig, cross: bool = False) -> list[Params]:
    p, r = pattern_info(cfg)
    return [tree_map_spec(lambda s: s.stacked(r),
                          block_spec(cfg, blk, cross=cross))
            for blk in cfg.pattern]


ENCODER_BLOCK = BlockSpec(mixer="attention", mlp="dense")


def encoder_stack_spec(cfg: ModelConfig) -> list[Params]:
    bs = block_spec(cfg, ENCODER_BLOCK)
    return [tree_map_spec(lambda s: s.stacked(cfg.encoder_layers), bs)]


def model_spec(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    vp = cfg.padded_vocab()
    spec: Params = {
        "embed": TensorSpec((vp, d), ("vocab", "fsdp"), fan_in_axes=(1,)),
        "blocks": decoder_stack_spec(cfg, cross=cfg.encoder_layers > 0),
        "final_norm": L.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = TensorSpec((d, vp), ("fsdp", "vocab"))
    if cfg.encoder_layers > 0:
        spec["encoder"] = {
            "blocks": encoder_stack_spec(cfg),
            "final_norm": L.norm_spec(cfg),
        }
    return spec


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def attn_cache_spec(cfg: ModelConfig, batch: int, cache_len: int,
                    virtual_kv: int) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "k": TensorSpec((batch, cache_len, virtual_kv, hd),
                        ("batch", "cache_seq", "kv", None),
                        dtype=torch.bfloat16, init="zeros"),
        "v": TensorSpec((batch, cache_len, virtual_kv, hd),
                        ("batch", "cache_seq", "kv", None),
                        dtype=torch.bfloat16, init="zeros"),
        "pos": TensorSpec((batch, cache_len), ("batch", "cache_seq"),
                          dtype=torch.int32, init="zeros"),
    }


def mixer_cache_spec(cfg: ModelConfig, blk: BlockSpec, batch: int,
                     cache_len: int, virtual_kv: int) -> Params:
    if blk.mixer == "attention":
        clen = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
        return attn_cache_spec(cfg, batch, clen, virtual_kv)
    if blk.mixer == "mamba":
        return L.mamba_cache_spec(cfg, batch)
    if blk.mixer == "mlstm":
        return L.mlstm_cache_spec(cfg, batch)
    if blk.mixer == "slstm":
        return L.slstm_cache_spec(cfg, batch)
    raise ValueError(blk.mixer)


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int, virtual_kv: int,
               enc_len: int = 0) -> list[Params]:
    """Per pattern position, stacked over R. Cross caches included for encdec."""
    p, r = pattern_info(cfg)
    out = []
    for blk in cfg.pattern:
        cs: Params = {"self": mixer_cache_spec(cfg, blk, batch, cache_len,
                                               virtual_kv)}
        if cfg.encoder_layers > 0 and enc_len > 0:
            cs["cross"] = attn_cache_spec(cfg, batch, enc_len, virtual_kv)
            del cs["cross"]["pos"]  # cross positions are static iota
        out.append(tree_map_spec(lambda s: s.stacked(r), cs))
    return out


# ---------------------------------------------------------------------------
# Cache fill helpers
# ---------------------------------------------------------------------------


def fill_cache(full: torch.Tensor, positions: torch.Tensor, cache_len: int):
    """Store the last cache_len entries of [B,S,...] at slots p % cache_len.

    Returns (cache, pos_array [B, cache_len]).
    """
    s = full.shape[1]
    if s <= cache_len:
        pad = [0, 0] * (full.ndim - 2) + [0, cache_len - s]
        return (F.pad(full, pad),
                F.pad(positions, (0, cache_len - s), value=-1))
    tail = full[:, s - cache_len:]
    tpos = positions[:, s - cache_len:]
    shift = s % cache_len
    return torch.roll(tail, shift, dims=1), torch.roll(tpos, shift, dims=1)


def cache_write_decode(cache_k, cache_v, cache_pos, k1, v1, pos):
    """Write one token at slot pos % cache_len (per batch row). pos: [B].
    Functional like the reference (the dense path is the oracle)."""
    clen = cache_k.shape[1]
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    slot = (pos % clen).long()
    ck, cv, cp = cache_k.clone(), cache_v.clone(), cache_pos.clone()
    ck[rows, slot] = k1[:, 0]
    cv[rows, slot] = v1[:, 0]
    cp[rows, slot] = pos.to(cp.dtype)
    return ck, cv, cp


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SeqCtx:
    """Context for a full-sequence pass (prefill)."""
    positions: torch.Tensor         # [B, S]
    want_cache: bool = False
    cache_len: int = 0
    virtual_kv: int = 0
    enc_out: torch.Tensor | None = None
    enc_pos: torch.Tensor | None = None
    attn_impl: str = "flash"        # flash | reference (plain, dense)


def _self_attn_seq(cfg, p, x, ctx: SeqCtx):
    q, k, v = L.qkv_project(cfg, p, x, ctx.positions, ctx.virtual_kv)
    if ctx.attn_impl == "flash":
        # positions are arange(S): the causal mask over indices is the
        # causal mask over positions
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=cfg.sliding_window).transpose(1, 2)
    elif ctx.attn_impl == "reference":
        o = L.attn_reference(cfg, q, k, v, ctx.positions, ctx.positions,
                             window=cfg.sliding_window)
    else:
        raise ValueError(f"unknown attn_impl {ctx.attn_impl!r}")
    y = L.attn_out(cfg, p, o)
    cache = None
    if ctx.want_cache:
        clen = (min(ctx.cache_len, cfg.sliding_window)
                if cfg.sliding_window else ctx.cache_len)
        ck, cpos = fill_cache(k, ctx.positions, clen)
        cv, _ = fill_cache(v, ctx.positions, clen)
        cache = {"k": ck, "v": cv, "pos": cpos}
    return y, cache


def _cross_attn_seq(cfg, p, x, ctx: SeqCtx):
    """Cross attention for enc-dec; enc_out already normed. The flash
    kernel runs it non-causal, Sq decoder queries over Sk encoder keys."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k = torch.einsum("bsd,dhk->bshk", ctx.enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", ctx.enc_out, p["wv"])
    k = L._expand_kv(k, ctx.virtual_kv)
    v = L._expand_kv(v, ctx.virtual_kv)
    if ctx.attn_impl == "flash":
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                causal=False).transpose(1, 2)
    elif ctx.attn_impl == "reference":
        o = L.attn_reference(cfg, q, k, v, ctx.positions, ctx.enc_pos,
                             cross=True)
    else:
        raise ValueError(f"unknown attn_impl {ctx.attn_impl!r}")
    return L.attn_out(cfg, p, o), {"k": k, "v": v}


_MIXERS_SEQ = {"mamba": L.apply_mamba_seq, "mlstm": L.apply_mlstm_seq,
               "slstm": L.apply_slstm_seq}
_MIXERS_DECODE = {"mamba": L.apply_mamba_decode,
                  "mlstm": L.apply_mlstm_decode,
                  "slstm": L.apply_slstm_decode}


def _mlp(cfg: ModelConfig, blk: BlockSpec, p: Params, x: torch.Tensor):
    """The block's MLP over its pre-norm: (y, MoE aux loss or None)."""
    h = L.apply_norm(cfg, p["norm2"], x)
    if blk.mlp == "moe":
        return L.apply_moe(cfg, p["mlp"], h)
    return L.apply_mlp(cfg, p["mlp"], h), None


def apply_block_seq(cfg: ModelConfig, blk: BlockSpec, p: Params,
                    x: torch.Tensor, ctx: SeqCtx):
    """Returns (x, cache_dict_or_None, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(cfg, p["norm1"], x)
    cache: Params = {}
    if blk.mixer == "attention":
        y, cache["self"] = _self_attn_seq(cfg, p["attn"], h, ctx)
    else:
        y, cache["self"] = _MIXERS_SEQ[blk.mixer](cfg, p["attn"], h)
    x = x + y
    if "cross" in p:
        h = L.apply_norm(cfg, p["norm_cross"], x)
        y, cache["cross"] = _cross_attn_seq(cfg, p["cross"], h, ctx)
        x = x + y
    if cfg.d_ff > 0:
        y, a = _mlp(cfg, blk, p, x)
        x = x + y
        if a is not None:
            aux = aux + a
    return x, (cache if ctx.want_cache else None), aux


def _self_attn_decode(cfg, p, x, pos, cache, virtual_kv):
    q, k1, v1 = L.qkv_project(cfg, p, x, pos[:, None], virtual_kv)
    ck, cv, cpos = cache_write_decode(
        cache["k"], cache["v"], cache["pos"], k1, v1, pos)
    o = L.attn_reference(cfg, q, ck, cv, pos[:, None], cpos,
                         window=cfg.sliding_window)
    return L.attn_out(cfg, p, o), {"k": ck, "v": cv, "pos": cpos}


def _cross_attn_decode(cfg, p, x, pos, cache, enc_pos):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    o = L.attn_reference(cfg, q, cache["k"], cache["v"], pos[:, None],
                         enc_pos, cross=True)
    return L.attn_out(cfg, p, o), cache


def apply_block_decode(cfg: ModelConfig, blk: BlockSpec, p: Params,
                       x: torch.Tensor, pos: torch.Tensor, cache: Params,
                       virtual_kv: int, enc_pos: torch.Tensor | None = None):
    """Dense-cache decode (the oracle path). x: [B,1,D]; pos: [B].
    Returns (x, new_cache)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    new_cache: Params = {}
    if blk.mixer == "attention":
        y, new_cache["self"] = _self_attn_decode(
            cfg, p["attn"], h, pos, cache["self"], virtual_kv)
    else:
        y, new_cache["self"] = _MIXERS_DECODE[blk.mixer](
            cfg, p["attn"], h, cache["self"])
    x = x + y
    if "cross" in p:
        h = L.apply_norm(cfg, p["norm_cross"], x)
        y, new_cache["cross"] = _cross_attn_decode(
            cfg, p["cross"], h, pos, cache["cross"], enc_pos)
        x = x + y
    if cfg.d_ff > 0:
        x = x + _mlp(cfg, blk, p, x)[0]
    return x, new_cache


def apply_block_decode_paged(cfg: ModelConfig, blk: BlockSpec, p: Params,
                             x: torch.Tensor, pos: torch.Tensor,
                             pool: torch.Tensor, layer: int,
                             block_tables: torch.Tensor,
                             context_lens: torch.Tensor,
                             write_frames: torch.Tensor,
                             write_offsets: torch.Tensor, virtual_kv: int):
    """One decode block through the paged KV pool (no slot-dense cache).

    ``pool``: [frames, page, L, 2, vh, hd] — the single physical page buffer
    shared by every layer; ``layer`` selects the L-axis slice. The new
    token's K/V land at (write_frames[b], write_offsets[b]) in place (idle
    rows all write the masked null frame; those duplicate writes land in no
    defined order and nothing reads them), then attention reads the layer
    slice through ``block_tables``/``context_lens`` with the paged decode
    kernel. Returns (x, pool).
    """
    if blk.mixer != "attention":
        raise NotImplementedError(
            "paged decode supports attention mixers only; recurrent-state "
            f"mixer {blk.mixer!r} needs a per-slot state slab (ROADMAP)")
    h = L.apply_norm(cfg, p["norm1"], x)
    q, k1, v1 = L.qkv_project(cfg, p["attn"], h, pos[:, None], virtual_kv)
    pool[write_frames, write_offsets, layer, 0] = k1[:, 0].to(pool.dtype)
    pool[write_frames, write_offsets, layer, 1] = v1[:, 0].to(pool.dtype)
    kv_l = pool[:, :, layer]                  # strided view, no copy
    o = ops.paged_decode_attention(q[:, 0], kv_l[:, :, 0], kv_l[:, :, 1],
                                   block_tables, context_lens,
                                   window=cfg.sliding_window)
    x = x + L.attn_out(cfg, p["attn"], o[:, None])
    if cfg.d_ff > 0:
        x = x + _mlp(cfg, blk, p, x)[0]
    return x, pool


def apply_block_prefill_paged(cfg: ModelConfig, blk: BlockSpec, p: Params,
                              x: torch.Tensor, start: int,
                              pool: torch.Tensor, layer: int,
                              block_table: torch.Tensor, context_len: int,
                              write_frames: torch.Tensor,
                              write_offsets: torch.Tensor, virtual_kv: int):
    """One prefill *chunk* through the paged KV pool (incremental prefill).

    ``x``: [1, C, D] — the chunk's tokens at absolute positions
    ``start..start+C-1``; the chunk's K/V land in place at
    (write_frames[t], write_offsets[t]) per token, then the chunk's queries
    attend over the request's whole resident context (``block_table`` [nb]
    / ``context_len``) with the paged chunk-prefill kernel — no prefix
    recompute. ``start`` and ``context_len`` are host ints, so no layer
    reads a device scalar. Returns (x, pool).
    """
    if blk.mixer != "attention":
        raise NotImplementedError(
            "paged chunk prefill supports attention mixers only; "
            f"recurrent-state mixer {blk.mixer!r} needs a state slab")
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            "paged chunk prefill has no sliding-window mask")
    positions = (start + torch.arange(x.shape[1], dtype=torch.int32,
                                      device=x.device))[None]
    h = L.apply_norm(cfg, p["norm1"], x)
    q, k1, v1 = L.qkv_project(cfg, p["attn"], h, positions, virtual_kv)
    pool[write_frames, write_offsets, layer, 0] = k1[0].to(pool.dtype)
    pool[write_frames, write_offsets, layer, 1] = v1[0].to(pool.dtype)
    kv_l = pool[:, :, layer]                  # strided view, no copy
    o = ops.paged_chunk_attention(q[0], kv_l[:, :, 0], kv_l[:, :, 1],
                                  block_table, start, context_len)
    x = x + L.attn_out(cfg, p["attn"], o[None])
    if cfg.d_ff > 0:
        x = x + _mlp(cfg, blk, p, x)[0]
    return x, pool


# ---------------------------------------------------------------------------
# Stack application (loop over R periods)
# ---------------------------------------------------------------------------


def unit_slice(blocks: Any, r: int) -> Any:
    """Unit ``r`` of a stacked block tree (leading dim dropped)."""
    return tree_map(lambda t: t[r], blocks)


def apply_stack_seq(cfg: ModelConfig, blocks: list[Params], x: torch.Tensor,
                    ctx: SeqCtx, pattern: tuple[BlockSpec, ...] | None = None):
    """Returns (x, caches_or_None, total_aux); caches are stacked [R, ...]
    per pattern position, as the reference's scan returns them. R is the
    blocks' leading dim (the encoder's stack has its own)."""
    pattern = pattern if pattern is not None else cfg.pattern
    r = tree_leaves(blocks)[0].shape[0]
    per_unit, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(r):
        ps = unit_slice(blocks, u)
        caches = []
        for j, blk in enumerate(pattern):
            x, c, a = apply_block_seq(cfg, blk, ps[j], x, ctx)
            caches.append(c)
            aux = aux + a
        per_unit.append(caches)
    if not ctx.want_cache:
        return x, None, aux
    return x, tree_map(lambda *xs: torch.stack(xs), *per_unit), aux


def apply_stack_decode(cfg: ModelConfig, blocks: list[Params],
                       x: torch.Tensor, pos: torch.Tensor,
                       caches: list[Params], virtual_kv: int,
                       enc_pos: torch.Tensor | None = None,
                       pattern: tuple[BlockSpec, ...] | None = None):
    pattern = pattern if pattern is not None else cfg.pattern
    r = tree_leaves(blocks)[0].shape[0]
    new_units = []
    for u in range(r):
        ps, cs = unit_slice(blocks, u), unit_slice(caches, u)
        new = []
        for j, blk in enumerate(pattern):
            x, nc = apply_block_decode(cfg, blk, ps[j], x, pos, cs[j],
                                       virtual_kv, enc_pos)
            new.append(nc)
        new_units.append(new)
    return x, tree_map(lambda *xs: torch.stack(xs), *new_units)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def lm_logits(cfg: ModelConfig, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, head)
