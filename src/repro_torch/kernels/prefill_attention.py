"""Paged GQA chunk-prefill attention (incremental prefill): the Hopper
kernel's wrapper and its plain version.

Replaces ``repro/kernels/prefill_attention.py: paged_chunk_attention_pallas``.
The C queries of one request's prompt chunk, at absolute positions
``start..start+C-1``, attend causally over that request's pages through one
block table: the prefix pages earlier chunks wrote plus the chunk's own. The
CUDA kernel (``csrc/prefill_attention.cu``) does about
``4 * H * D * sum_t (start + t + 1)`` FLOPs against one read of the live
pages, so a long chunk is bound by operations, and it runs both products on
the tensor cores (``mma.sync``). A thread block's 64 rows hold all ``H / V``
query heads of its tokens, so each K/V tile, copied in 16-byte pieces
through the block table and the pool's layer strides, serves every head of
the group. Each block's keys (up to its last query position: causal
pruning) are split into fixed spans of ``SPAN_KEYS`` keys, one block per
(token tile, KV head, span), so one request's chunk fills the card; a tile
with several spans writes fp32 partials to a scratch this wrapper
allocates, and a second kernel, launched from the same C entry point,
merges them in span order.

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
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 64          # query heads per KV head the kernel's row tile holds
# keys per split span: kSpan of csrc/prefill_attention.cu (each launch checks
# split_geometry's span count against the library's)
SPAN_KEYS = 256

# kernel launches since the last reset (the main-path evidence)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_launch_fn = None
_splits_fn = None


def _clamped(nb: int, page: int, start: int,
             context_len: int) -> tuple[int, int]:
    """The Pallas wrapper's clamps: ``context_len`` into the table's
    capacity ``[0, nb*page]``, then ``start`` into ``[0, context_len]``."""
    cl = min(max(int(context_len), 0), nb * page)
    return min(max(int(start), 0), cl), cl


def key_end(c: int, page: int, start: int, context_len: int) -> int:
    """Keys ``[0, key_end)`` that some query of the chunk may see, for a
    clamped ``start`` and ``context_len``: the live pages
    (``ceil(context_len / page) * page``), none past the last query
    position ``start + c - 1``."""
    return min(-(-context_len // page) * page, start + c)


def split_geometry(c: int, h: int, vh: int, d: int,
                   k_end: int) -> tuple[int, dict[str, tuple[int, ...]]]:
    """The split kernel's geometry for one launch whose last token tile
    sees keys ``[0, k_end)``: the number of spans S (``SPAN_KEYS`` keys
    each, at least one) and the fp32 partials of a launch with S > 1, laid
    out one after another in one scratch buffer: ``acc`` ``(S, V, C*g,
    D)``, then ``m`` and ``l`` ``(S, V, C*g)``, rows in the Pallas
    ``[V, C*G]`` order."""
    splits = max(1, -(-k_end // SPAN_KEYS))
    rows = (splits, vh, c * (h // vh))
    return splits, {"acc": rows + (d,), "m": rows, "l": rows}


def check_kernel_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor,
                        block_table: torch.Tensor) -> None:
    """Raise unless the kernel can take these inputs, wherever they lie:
    bf16, unit stride along head_dim, views the 16-byte copies can read
    (``_build.require_vector_aligned``), head_dim in ``HEAD_DIMS``,
    ``V | H``, ``H / V <= MAX_GROUP`` and a 1-D table."""
    c, h, d = q.shape
    _, _, vh, dk = k_pages.shape
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
        _build.require_vector_aligned(name, t)
    if (d not in HEAD_DIMS or v_pages.shape != k_pages.shape or dk != d
            or h % vh or h // vh > MAX_GROUP):
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"(head_dim in {HEAD_DIMS}, V | H, H / V <= "
                         f"{MAX_GROUP})")
    if block_table.dim() != 1:
        raise ValueError(f"block_table {tuple(block_table.shape)}: need [nb]")


def _kernel():
    """The library's launch entry and its span count, loaded once."""
    global _launch_fn, _splits_fn
    if _launch_fn is None:
        lib = _build.load("prefill_attention")
        sp = lib.paged_chunk_splits
        sp.argtypes, sp.restype = [ctypes.c_int] * 6, ctypes.c_int
        fn = lib.paged_chunk_attention_bf16
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _launch_fn, _splits_fn = fn, sp
    return _launch_fn, _splits_fn


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
    """Launch the Hopper kernels. q and the pages may be strided views (the
    engine passes the chunk's projections and a layer slice of its 6-D
    pool); only D must be unit-stride, and the 16-byte copies need them
    16-byte aligned with strides in multiples of 8 elements. ``start`` and
    ``context_len`` are host ints, passed as kernel arguments: no device
    scalar is read."""
    global launches
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda:
            raise ValueError(f"{name}: need a bf16 CUDA tensor, got "
                             f"{t.dtype} {t.device}")
    check_kernel_inputs(q, k_pages, v_pages, block_table)
    c, h, d = q.shape
    npages, page, vh, _ = k_pages.shape
    nb = block_table.shape[0]
    st, cl = _clamped(nb, page, start, context_len)
    out = torch.empty((c, h, d), dtype=q.dtype, device=q.device)
    ints = (c, h, vh, d, page, nb, npages, st, cl, q.stride(0), q.stride(1),
            *k_pages.stride()[:3], *v_pages.stride()[:3])
    if max(ints) >= 2**31 or c * h * d >= 2**31 or nb * page >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    if c == 0:
        return out
    launch, lib_splits = _kernel()
    splits, parts = split_geometry(c, h, vh, d, key_end(c, page, st, cl))
    if lib_splits(c, h, vh, page, st, cl) != splits:
        raise RuntimeError("prefill_attention.cu splits this launch's keys "
                           "differently from split_geometry")
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    part = (torch.empty(sum(math.prod(s) for s in parts.values()),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    err = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 bt.data_ptr(), None if part is None else part.data_ptr(),
                 out.data_ptr(), *ints,
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
