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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.spec import (TensorSpec, tree_leaves, tree_map,
                                     tree_map_spec)
from repro_torch.sharding.rules import shard

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

    Returns (cache, pos_array [B, cache_len]). A DTensor fills each rank's
    rows and heads (``_fill`` on its local shard).
    """
    return _fill(full, cache_len, 0), _fill(positions, cache_len, -1)


def _fill(x: torch.Tensor, cache_len: int, pad_value: int) -> torch.Tensor:
    """``fill_cache`` of one tensor: padded with ``pad_value`` to
    cache_len, or its last cache_len entries rolled into place."""
    if isinstance(x, DTensor):
        keep = tuple(pl if pl in (Shard(0), Shard(2)) else Replicate()
                     for pl in x.placements)
        return local_map(lambda t: _fill(t, cache_len, pad_value),
                         out_placements=(keep,), in_placements=(keep,),
                         redistribute_inputs=True,
                         device_mesh=x.device_mesh)(x)
    s = x.shape[1]
    if s <= cache_len:
        pad = [0, 0] * (x.ndim - 2) + [0, cache_len - s]
        return F.pad(x, pad, value=pad_value)
    return torch.roll(x[:, s - cache_len:], s % cache_len, dims=1)


def cache_write_decode(cache_k, cache_v, cache_pos, k1, v1, pos):
    """Write one token at slot pos % cache_len (per batch row). pos: [B].
    Functional like the reference (the dense path is the oracle). DTensor
    caches are written shard by shard (``_cache_write_shards``)."""
    if isinstance(cache_k, DTensor):
        return _cache_write_shards(cache_k, cache_v, cache_pos, k1, v1, pos)
    clen = cache_k.shape[1]
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    slot = (pos % clen).long()
    ck, cv, cp = cache_k.clone(), cache_v.clone(), cache_pos.clone()
    ck[rows, slot] = k1[:, 0]
    cv[rows, slot] = v1[:, 0]
    cp[rows, slot] = pos.to(cp.dtype)
    return ck, cv, cp


def _cache_write_shards(cache_k, cache_v, cache_pos, k1, v1, pos):
    """``cache_write_decode`` of DTensor caches ``[B, S, V, hd]``, each rank
    writing its own shard: its batch rows and KV heads, and, where the
    cache's sequence is sharded (a batch too small to shard), only the
    slots it holds (elsewhere it writes back what the slot held)."""
    mesh, kpl = cache_k.device_mesh, tuple(cache_k.placements)
    clen = cache_k.shape[1]
    # this rank's first slot: mesh dims split the sequence major to minor
    seq_lo, span = 0, clen
    for i, pl in enumerate(kpl):
        if pl == Shard(1):
            span //= mesh.size(i)
            seq_lo += mesh.get_coordinate()[i] * span
    keep = lambda *dims: tuple(pl if pl in [Shard(d) for d in dims]
                               else Replicate() for pl in kpl)
    tok_pl, pos_pl, cp_pl = keep(0, 2), keep(0), keep(0, 1)

    def local(ck, cv, cp, k1, v1, pos):
        rows = torch.arange(ck.shape[0], device=ck.device)
        slot = (pos % clen).long() - seq_lo
        hit = (slot >= 0) & (slot < ck.shape[1])
        slot = slot.clamp(0, ck.shape[1] - 1)
        ck, cv, cp = ck.clone(), cv.clone(), cp.clone()
        ck[rows, slot] = torch.where(hit[:, None, None], k1[:, 0],
                                     ck[rows, slot])
        cv[rows, slot] = torch.where(hit[:, None, None], v1[:, 0],
                                     cv[rows, slot])
        cp[rows, slot] = torch.where(hit, pos.to(cp.dtype), cp[rows, slot])
        return ck, cv, cp

    return local_map(local, out_placements=(kpl, kpl, cp_pl),
                     in_placements=(kpl, kpl, cp_pl, tok_pl, tok_pl, pos_pl),
                     redistribute_inputs=True, device_mesh=mesh)(
        cache_k, cache_v, cache_pos, k1, v1, pos)


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
        o = ops.flash_attention_padded(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=cfg.sliding_window).transpose(1, 2)
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
    q = torch.einsum("bsd,dhk->bshk", x,
                     L.gathered(p["wq"], "fsdp", "heads", "head_dim"))
    if cfg.qkv_bias:
        q = q + p["bq"]
    k = torch.einsum("bsd,dhk->bshk", ctx.enc_out,
                     L.gathered(p["wk"], "fsdp", "kv", "head_dim"))
    v = torch.einsum("bsd,dhk->bshk", ctx.enc_out,
                     L.gathered(p["wv"], "fsdp", "kv", "head_dim"))
    k = L._expand_kv(k, ctx.virtual_kv)
    v = L._expand_kv(v, ctx.virtual_kv)
    if ctx.attn_impl == "flash":
        o = ops.flash_attention_padded(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
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
    q = torch.einsum("bsd,dhk->bshk", x,
                     L.gathered(p["wq"], "fsdp", "heads", "head_dim"))
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


def _whole_for(pool: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a value to write into ``pool``: a DTensor gathered whole
    where the page pool is a plain tensor (every rank holds the whole
    pool)."""
    if isinstance(t, DTensor) and not isinstance(pool, DTensor):
        return t.full_tensor()
    return t


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
    k1, v1 = _whole_for(pool, k1), _whole_for(pool, v1)
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
    k1, v1 = _whole_for(pool, k1), _whole_for(pool, v1)
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


def unit_slices(blocks: Any) -> list[Any]:
    """Every unit of a stacked block tree, each leaf unbound once along
    its leading dim: the same views as ``unit_slice``, but autograd stacks
    the units' gradients in one op, where R separate slices would each add
    a zero-padded gradient of the whole stacked leaf (R^2 / 2 leaf-sized
    passes per backward)."""
    is_parts = lambda x: isinstance(x, tuple)
    parts = tree_map(lambda t: t.unbind(0), blocks)
    r = len(tree_leaves(parts, is_leaf=is_parts)[0])
    return [tree_map(lambda p, u=u: p[u], parts, is_leaf=is_parts)
            for u in range(r)]


def apply_stack_seq(cfg: ModelConfig, blocks: list[Params], x: torch.Tensor,
                    ctx: SeqCtx, pattern: tuple[BlockSpec, ...] | None = None,
                    remat: bool = False):
    """Returns (x, caches_or_None, total_aux); caches are stacked [R, ...]
    per pattern position, as the reference's scan returns them. R is the
    blocks' leading dim (the encoder's stack has its own).

    ``remat`` recomputes each period's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant, as the reference's
    ``jax.checkpoint(period)``); it keeps no caches."""
    pattern = pattern if pattern is not None else cfg.pattern
    if remat and ctx.want_cache:
        raise ValueError("remat keeps no caches: want_cache must be False")

    def period(x, aux, ps):
        caches = []
        for j, blk in enumerate(pattern):
            x, c, a = apply_block_seq(cfg, blk, ps[j], x, ctx)
            caches.append(c)
            aux = aux + a
        return x, caches, aux

    per_unit, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for ps in unit_slices(blocks):
        if remat:
            x, aux = checkpoint(lambda x, aux, ps=ps: period(x, aux, ps)[::2],
                                x, aux, use_reentrant=False)
        else:
            x, caches, aux = period(x, aux, ps)
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
    table = L.gathered(params["embed"], "vocab", "fsdp")
    ids = tokens.long()
    x = _lookup(table, ids) if isinstance(table, DTensor) else table[ids]
    return shard(x, "batch", None, None)


def _lookup(table: DTensor, ids: torch.Tensor) -> DTensor:
    """Rows ``ids`` of a DTensor table [V, D], vocab-parallel: on a mesh
    dim that splits the vocab each rank looks the ids up in its own rows
    (zeros for the others' ids) and the result is the pending sum over
    that dim (``Partial``), which the next constraint reduces; the ids'
    batch shards stay on every other mesh dim."""
    mesh, tpl = table.device_mesh, tuple(table.placements)
    vocab = [pl == Shard(0) for pl in tpl]
    lo, span = 0, table.shape[0]      # this rank's first row, major to minor
    for i, split in enumerate(vocab):
        if split:
            span //= mesh.size(i)
            lo += mesh.get_coordinate()[i] * span
    if isinstance(ids, DTensor):
        ids_pl = tuple(Shard(0) if pl == Shard(0) and not v else Replicate()
                       for pl, v in zip(ids.placements, vocab))
    else:
        ids_pl = tuple(Replicate() for _ in tpl)
    out_pl = tuple(Partial() if v else pl for v, pl in zip(vocab, ids_pl))
    # the table's gradient from each rank's ids is its part of the sum
    # over the ids' batch shards
    grad_pl = tuple(Partial() if pl == Shard(0) else t
                    for pl, t in zip(ids_pl, tpl))

    def local(tbl, ids):
        if not any(vocab):
            return tbl[ids]
        rows = ids - lo
        hit = (rows >= 0) & (rows < tbl.shape[0])
        out = tbl[rows.clamp(0, tbl.shape[0] - 1)]
        return torch.where(hit[..., None], out,
                           torch.zeros((), dtype=out.dtype, device=out.device))

    ids_in = ids_pl if isinstance(ids, DTensor) else None
    return local_map(local, out_placements=(out_pl,),
                     in_placements=(tpl, ids_in),
                     in_grad_placements=(grad_pl, ids_in),
                     redistribute_inputs=True, device_mesh=mesh)(table, ids)


def lm_logits(cfg: ModelConfig, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    head = L.gathered(params["embed"], "vocab", "fsdp").T \
        if cfg.tie_embeddings else L.gathered(params["lm_head"], "fsdp",
                                              "vocab")
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return shard(logits, "batch", None, "vocab")


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood, over fp32 logits."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def _row_nll(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """``_nll`` of DTensor logits ``[B, S, V]``, computed row by row on the
    ranks that hold the rows (the batch shards stay; a vocab shard is
    gathered first): the same arithmetic per row as on one device, where
    DTensor's own label gather would differentiate through a replicated
    zero gradient of the whole logits."""
    rows = tuple(p if p == Shard(0) else Replicate()
                 for p in logits.placements)
    return local_map(_nll, out_placements=(rows,),
                     in_placements=(rows, rows), redistribute_inputs=True,
                     device_mesh=logits.device_mesh)(logits, labels)


def xent_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy over fp32 logits (masked mean when a
    mask is given). DTensor logits take each row's loss on the rank that
    holds the row (``_row_nll``)."""
    nll = _row_nll(logits, labels) if isinstance(logits, DTensor) \
        else _nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def xent_loss_chunked(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor | None = None,
                      chunk: int = 512) -> torch.Tensor:
    """Big-vocab cross entropy from the final hidden states, one sequence
    chunk of fp32 logits at a time, each chunk recomputed in the backward
    (``torch.utils.checkpoint`` where the reference uses ``jax.checkpoint``).
    As in the reference it is an alternative, not wired into
    ``Model.loss_fn``."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def chunk_nll(h, y, m):
        # bf16 products are exact in fp32: fp32 logits of bf16 operands
        lf = torch.einsum("bsd,dv->bsv", h.float(), head.float())
        lf = shard(lf, "batch", None, "vocab")
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, y.long()[..., None])[..., 0]
        return ((lse - ll) * m).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        total = total + checkpoint(chunk_nll, hidden[:, sl], labels[:, sl],
                                   mask[:, sl], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)
