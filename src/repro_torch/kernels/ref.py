"""Dense torch oracles for the attention kernels (port of
``repro.kernels.ref``). O(S^2) memory — correctness checks at small shapes
only."""
from __future__ import annotations

import math

import torch


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,V,Sk,D] with V | H. Returns [B,H,Sq,D]."""
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    g = h // vh
    qf = q.reshape(b, vh, g, sq, d).float() / math.sqrt(d)
    s = torch.einsum("bvgqd,bvkd->bvgqk", qf, k.float())
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        # decode-style offset: query position sq-1 aligns with kv position
        # kv_len-1 when sq != sk
        off = (kv_len if kv_len is not None else sk) - sq
        valid &= kpos <= qpos + off
        if window > 0:
            valid &= kpos > qpos + off - window
    if kv_len is not None:
        valid &= kpos < kv_len
    s = s.masked_fill(~valid, -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bvgqk,bvkd->bvgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def ref_paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               context_lens: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """q: [B,H,D]; pages: [npages, page, V, D]; block_tables: [B, nb];
    context_lens: [B]. Returns [B,H,D]."""
    b, h, d = q.shape
    _, page, vh, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = h // vh
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, vh, d).float()
    v = v_pages[bt].reshape(b, nb * page, vh, d).float()
    qf = q.reshape(b, vh, g, d).float() / math.sqrt(d)
    s = torch.einsum("bvgd,bsvd->bvgs", qf, k)
    kpos = torch.arange(nb * page, device=q.device)[None]
    cl = context_lens.long()[:, None]
    valid = kpos < cl
    if window > 0:
        valid &= kpos >= cl - window
    s = s.masked_fill(~valid[:, None, None], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bvgs,bsvd->bvgd", p, v)
    return o.reshape(b, h, d).to(q.dtype)


def ref_paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor, start: int,
                              context_len: int) -> torch.Tensor:
    """q: [C,H,D] at absolute positions ``start..start+C-1``; pages:
    [npages, page, V, D]; block_table: [nb]. Returns [C,H,D].

    Dense over the whole table, with the chunk kernel's rules: table entries
    clamped into the pool, ``context_len`` into ``[0, nb*page]``, ``start``
    into ``[0, context_len]``; query t sees key position k when
    ``k <= start + t`` and k's page is live (``j * page < context_len``).
    There is no separate length mask, so keys past ``context_len`` inside
    the last live page stay visible to queries past it."""
    c, h, d = q.shape
    npages, page, vh, _ = k_pages.shape
    nb = block_table.shape[0]
    g = h // vh
    cl = min(max(int(context_len), 0), nb * page)
    st = min(max(int(start), 0), cl)
    bt = block_table.long().clamp(0, npages - 1)
    k = k_pages[bt].reshape(nb * page, vh, d).float()
    v = v_pages[bt].reshape(nb * page, vh, d).float()
    qf = q.reshape(c, vh, g, d).float() / math.sqrt(d)
    s = torch.einsum("cvgd,svd->cvgs", qf, k)
    kpos = torch.arange(nb * page, device=q.device)
    qpos = st + torch.arange(c, device=q.device)
    valid = ((kpos[None] <= qpos[:, None])
             & ((kpos // page * page) < cl)[None])          # [C, nb*page]
    s = s.masked_fill(~valid[:, None, None], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("cvgs,svd->cvgd", p, v)
    return o.reshape(c, h, d).to(q.dtype)
