"""Paged GQA decode attention: the Hopper kernel's wrapper and its plain
version.

Replaces ``repro/kernels/decode_attention.py: paged_decode_attention_pallas``.
The CUDA kernel (``csrc/decode_attention.cu``) is bandwidth-bound: one launch
reads about ``B * cl * V * D * 2 * 2`` bytes of KV. One thread block per
(request, KV head) serves all ``H / V`` query heads of that KV head from one
read of each page, and reads the pages in place through the pool's strides.

On a CPU tensor the wrapper runs the plain version, which repeats the
kernel's arithmetic (fp32 online softmax over pages) in PyTorch; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

# kernel launches since the last reset (the main-path evidence)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 context_lens: torch.Tensor, *,
                                 window: int = 0) -> torch.Tensor:
    """PyTorch version of the kernel: page-by-page online softmax in fp32,
    with the Pallas kernel's clamping and masking rules."""
    b, h, d = q.shape
    npages, page, vh, _ = k_pages.shape
    nb = block_tables.shape[1]
    g = h // vh
    bt = block_tables.long().clamp(0, npages - 1)
    cl = context_lens.long().clamp(0, nb * page)
    qf = q.float().reshape(b, vh, g, d) * (1.0 / math.sqrt(d))
    m = torch.full((b, vh, g), NEG_INF, device=q.device)
    l = torch.zeros((b, vh, g), device=q.device)
    acc = torch.zeros((b, vh, g, d), device=q.device)
    tpos = torch.arange(page, device=q.device)
    for j in range(nb):
        live = j * page < cl
        if window > 0:
            live &= (j + 1) * page > cl - window
        if not bool(live.any()):
            continue
        kj = k_pages[bt[:, j]].float()                    # [b, page, V, D]
        vj = v_pages[bt[:, j]].float()
        s = torch.einsum("bvgd,btvd->bvgt", qf, kj)
        kpos = j * page + tpos
        valid = kpos[None] < cl[:, None]                  # [b, page]
        if window > 0:
            valid &= kpos[None] >= (cl - window)[:, None]
        valid = valid[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        lv = live[:, None, None]
        l = torch.where(lv, l * alpha + p.sum(dim=-1), l)
        acc = torch.where(lv[..., None], acc * alpha[..., None]
                          + torch.einsum("bvgt,btvd->bvgd", p, vj), acc)
        m = torch.where(lv, m_new, m)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_tables: torch.Tensor,
                                context_lens: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Launch the Hopper kernel. Pages may be strided views (the engine
    passes a layer slice of its 6-D pool); only D must be unit-stride."""
    global launches
    b, h, d = q.shape
    npages, page, vh, dk = k_pages.shape
    nb = block_tables.shape[1]
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
    if v_pages.shape != k_pages.shape or dk != d or h % vh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if block_tables.shape != (b, nb) or context_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match batch {b}")
    ints = (b, h, vh, d, page, nb, npages, window, q.stride(0), q.stride(1),
            *k_pages.stride()[:3], *v_pages.stride()[:3])
    if max(ints) >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    cl = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    lib = _build.load("decode_attention")
    fn = lib.paged_decode_attention_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             bt.data_ptr(), cl.data_ptr(), out.data_ptr(), *ints,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention launch")
    launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: [B,H,D]; pages: [npages, page, V, D]; block_tables: [B, nb] int32;
    context_lens: [B] int32. Returns [B,H,D].

    Padded batches are first-class: table entries past a request's last live
    page may hold any value (clamped into the pool, masked by
    ``context_lens``), a row with ``context_lens[b] <= 0`` outputs zeros, and
    lengths are clamped to the table's capacity ``nb * page``."""
    if q.is_cuda:
        return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                           context_lens, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                        context_lens, window=window)
