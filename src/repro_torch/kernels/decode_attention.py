"""Paged GQA decode attention: the Hopper kernel's wrapper and its plain
version.

Replaces ``repro/kernels/decode_attention.py: paged_decode_attention_pallas``.
The CUDA kernel (``csrc/decode_attention.cu``) is bandwidth-bound: one launch
reads about ``B * cl * V * D * 2 * 2`` bytes of KV. It splits each request's
KV into spans of ``PAGES_PER_SPLIT`` table pages, one thread block per
(request, KV head, span), so enough blocks read at once; each block serves
all ``H / V`` query heads of its KV head from one read of each page, read in
place through the pool's strides in 16-byte pieces, and writes an fp32
partial softmax to a scratch this wrapper allocates. A second kernel,
launched from the same C entry point, merges the spans in order.

On a CPU tensor the wrapper runs the plain version, which repeats the
Pallas kernel's arithmetic (fp32 online softmax over pages) in PyTorch; on a
CUDA tensor it launches the kernel or raises. A DTensor query runs on its
local shard, replicated over the mesh (the block tables index the whole
batch); a fake tensor takes the kernel path and launches nothing
(``_build``). Each launch reports its FLOPs and bytes (chip_smoke's bound
formulas) to the cost counters.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.kernels import _build

NEG_INF = -1e30
# table pages per split: kPagesPerSplit of csrc/decode_attention.cu, which
# the wrapper checks against the built library
PAGES_PER_SPLIT = 4
# the head dims the kernel is built and checked for: D / 8 lanes split each
# key row, rounded up to a power of two up to a warp (h2o-danube-3-4b's 120
# runs 15 lanes of 16, the 16th adding zero)
HEAD_DIMS = (8, 16, 32, 64, 120, 128, 256)

# kernel launches since the last reset (the main-path evidence)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
_launch_fn = None


def split_geometry(b: int, h: int, vh: int, d: int,
                   nb: int) -> tuple[int, dict[str, tuple[int, ...]]]:
    """The split kernel's geometry for one launch: the number of splits S
    (spans of ``PAGES_PER_SPLIT`` table pages) and the fp32 partials it
    writes, laid out one after another in one scratch buffer: ``acc``
    ``(B, V, S, g, D)``, then ``m`` and ``l`` ``(B, V, S, g)``."""
    splits = -(-nb // PAGES_PER_SPLIT)
    rows = (b, vh, splits, h // vh)
    return splits, {"acc": rows + (d,), "m": rows, "l": rows}


def _kernel():
    global _launch_fn
    if _launch_fn is None:
        lib = _build.load("decode_attention")
        if lib.paged_decode_pages_per_split() != PAGES_PER_SPLIT:
            raise RuntimeError("decode_attention.cu splits KV differently "
                               "from the wrapper's PAGES_PER_SPLIT")
        fn = lib.paged_decode_attention_bf16
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _launch_fn = fn
    return _launch_fn


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
    """Launch the Hopper kernels. Pages may be strided views (the engine
    passes a layer slice of its 6-D pool); only D must be unit-stride, and
    the 16-byte loads need the pages 16-byte aligned with strides in
    multiples of 8 elements."""
    global launches
    b, h, d = q.shape
    npages, page, vh, dk = k_pages.shape
    nb = block_tables.shape[1]
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not _build.on_kernel_path(t) or t.dtype != torch.bfloat16 \
                or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
        if t is not q:
            _build.require_vector_aligned(name, t)
    if v_pages.shape != k_pages.shape or dk != d or h % vh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {d} (need one of "
                         f"{HEAD_DIMS})")
    if block_tables.shape != (b, nb) or context_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match batch {b}")
    parts = split_geometry(b, h, vh, d, nb)[1]
    ints = (b, h, vh, d, page, nb, npages, window, q.stride(0), q.stride(1),
            *k_pages.stride()[:3], *v_pages.stride()[:3])
    if max(ints) >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    cl = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or nb == 0:           # no batch, or no page: all rows idle
        return out.zero_()
    part = torch.empty(sum(math.prod(s) for s in parts.values()),
                       dtype=torch.float32, device=q.device)
    tokens = _live_tokens(cl, nb * page)
    cost = (4 * tokens * h * d,               # QK^T and PV
            tokens * vh * d * 2 * 2           # K and V, bf16
            + 2 * b * h * d * 2               # q in, out
            + bt.numel() * 4 + cl.numel() * 4)
    if _build.is_fake(q):
        _build.report("paged_decode_attention", *cost)
        return out
    err = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    bt.data_ptr(), cl.data_ptr(), part.data_ptr(),
                    out.data_ptr(), *ints,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention launch")
    launches += 1
    _build.report("paged_decode_attention", *cost)
    return out


def _live_tokens(context_lens: torch.Tensor, capacity: int) -> int:
    """Keys the launch reads: the context lengths clamped to the table's
    capacity, summed. Read from the device only while a cost counter
    listens (a fake tensor's lengths are unknown: the capacity counts)."""
    if _build.is_fake(context_lens):
        return context_lens.shape[0] * capacity
    if not _build.COST_SINKS:
        return 0
    with _disable_current_modes():
        return int(context_lens.clamp(0, capacity).sum())


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
    if isinstance(q, DTensor):
        return _build.on_local_shards(
            paged_decode_attention, q, k_pages, v_pages, block_tables,
            context_lens, window=window)
    if _build.on_kernel_path(q):
        return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                           context_lens, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                        context_lens, window=window)
