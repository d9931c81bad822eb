"""Paged GQA chunk-prefill attention (incremental prefill): the Hopper
kernel's wrapper and its plain version.

Replaces ``repro/kernels/prefill_attention.py: paged_chunk_attention_pallas``.
The C queries of one request's prompt chunk, at absolute positions
``start..start+C-1``, attend causally over that request's pages through one
block table: the prefix pages earlier chunks wrote plus the chunk's own. The
CUDA kernel (``csrc/prefill_attention.cu``) does about
``4 * H * D * sum_t (start + t + 1)`` FLOPs against one read of the live
pages, so a long chunk is bound by operations. One thread block per (tile of
query tokens, KV head) holds all ``H / V`` query heads of its tokens, so each
K/V page is read once per tile and serves every head of the group; it walks
the pages in order up to the tile's last query position (causal pruning
keeps a chunk's work O(C * prefix)), and reads them in place through the
pool's layer strides.

On a CPU tensor the wrapper runs the plain version, which repeats the
Pallas kernel's arithmetic (fp32 online softmax page by page, queries scaled
in fp32); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64          # query heads per KV head the kernel's row tile holds

# kernel launches since the last reset (the main-path evidence)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17 + [ctypes.c_void_p]


def _clamped(nb: int, page: int, start: int,
             context_len: int) -> tuple[int, int]:
    """The Pallas wrapper's clamps: ``context_len`` into the table's
    capacity ``[0, nb*page]``, then ``start`` into ``[0, context_len]``."""
    cl = min(max(int(context_len), 0), nb * page)
    return min(max(int(start), 0), cl), cl


def paged_chunk_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_table: torch.Tensor, start: int,
                                context_len: int) -> torch.Tensor:
    """PyTorch version of the kernel: page-by-page online softmax in fp32
    over the live pages (``j * page < context_len``), keys masked by
    ``kpos <= start + t`` only, ``l`` clamped at 1e-30. A page that starts
    after the last query position is all masked, an exact no-op on
    (m, l, acc), so the walk stops there as the kernel's does."""
    c, h, d = q.shape
    npages, page, vh, _ = k_pages.shape
    nb = block_table.shape[0]
    g = h // vh
    st, cl = _clamped(nb, page, start, context_len)
    bt = block_table.long().clamp(0, npages - 1)
    qf = q.float().reshape(c, vh, g, d) * (1.0 / math.sqrt(d))
    m = torch.full((c, vh, g), NEG_INF, device=q.device)
    l = torch.zeros((c, vh, g), device=q.device)
    acc = torch.zeros((c, vh, g, d), device=q.device)
    qpos = st + torch.arange(c, device=q.device)
    tpos = torch.arange(page, device=q.device)
    for j in range(nb):
        if j * page >= cl or j * page > st + c - 1:
            break
        kj = k_pages[bt[j]].float()                       # [page, V, D]
        vj = v_pages[bt[j]].float()
        s = torch.einsum("cvgd,tvd->cvgt", qf, kj)
        valid = ((j * page + tpos)[None] <= qpos[:, None])[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("cvgt,tvd->cvgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(c, h, d).to(q.dtype)


def paged_chunk_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_table: torch.Tensor, start: int,
                               context_len: int) -> torch.Tensor:
    """Launch the Hopper kernel. q and the pages may be strided views (the
    engine passes the chunk's projections and a layer slice of its 6-D
    pool); only D must be unit-stride. ``start`` and ``context_len`` are
    host ints, passed as kernel arguments: no device scalar is read."""
    global launches
    c, h, d = q.shape
    npages, page, vh, dk = k_pages.shape
    nb = block_table.shape[0]
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
    if (d not in HEAD_DIMS or v_pages.shape != k_pages.shape or dk != d
            or h % vh or h // vh > MAX_GROUP):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"(head_dim in {HEAD_DIMS}, V | H, H / V <= "
                         f"{MAX_GROUP})")
    if block_table.dim() != 1:
        raise ValueError(f"block_table {tuple(block_table.shape)}: need [nb]")
    st, cl = _clamped(nb, page, start, context_len)
    out = torch.empty((c, h, d), dtype=q.dtype, device=q.device)
    ints = (c, h, vh, d, page, nb, npages, st, cl, q.stride(0), q.stride(1),
            *k_pages.stride()[:3], *v_pages.stride()[:3])
    if max(ints) >= 2**31 or c * h * d >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    if c == 0:
        return out
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    lib = _build.load("prefill_attention")
    fn = lib.paged_chunk_attention_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             bt.data_ptr(), out.data_ptr(), *ints,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_chunk_attention launch")
    launches += 1
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          start: int, context_len: int) -> torch.Tensor:
    """q: [C,H,D] — the chunk's queries at absolute positions
    ``start..start+C-1``; pages: [npages, page, V, D]; block_table: [nb]
    int32 covering the request's pages ``0..ceil(context_len/page)-1``;
    ``context_len`` = start + C (the chunk's own KV is already in the pool).
    Returns [C,H,D].

    Table entries past the last live page may hold any value (clamped into
    the pool); ``context_len`` is clamped to ``[0, nb*page]`` and ``start``
    to ``[0, context_len]``; ``context_len`` 0 gives zeros."""
    if q.is_cuda:
        return paged_chunk_attention_cuda(q, k_pages, v_pages, block_table,
                                          start, context_len)
    if q.device.type != "cpu":
        raise ValueError(f"paged_chunk_attention: no kernel for {q.device}")
    return paged_chunk_attention_plain(q, k_pages, v_pages, block_table,
                                       start, context_len)
