"""Flash attention (prefill and training): the Hopper kernels' wrappers,
their plain versions and the autograd function that joins them.

Replaces ``repro/kernels/flash_attention.py: flash_attention_pallas``. The
CUDA kernel (``csrc/flash_attention.cu``) is compute-bound for long prompts:
about ``2 * B * H * Sq * Sk * D`` FLOPs under the causal mask, which it runs
on the tensor cores (``mma.sync`` bf16 -> fp32). One block of 4 warps per
(query tile of 64 rows, head, batch row) keeps its query fragments and the
running softmax state in registers, streams 64-key tiles through a
three-stage shared ring, and skips KV tiles the masks leave empty, as
the Pallas kernel does. It rounds the probabilities to bf16 before the PV
product, where the Pallas kernel keeps them in fp32.

On a CPU tensor the wrapper runs the plain version, which repeats the
Pallas kernel's arithmetic (fp32 online softmax over 64-key tiles, queries
scaled in fp32) in PyTorch; on a CUDA tensor it launches the kernel or
raises.

The backward (training) differentiates the same function; the reference
takes that gradient with ``jax.grad`` of ``attn_chunked``, the Pallas
kernel's jnp twin. Its CUDA kernels (``flash_attention_bwd_bf16`` in the
same source, head dims 16-256) recompute P from Q, K and the forward's
log-sum-exp: bound by operations, seven products (five, and the dQ pass's
recomputed two) against the forward's two. Design for Hopper: every
product is a warpgroup ``wgmma`` on tiles TMA copies into swizzled shared
memory, kept full by a producer through an mbarrier ring. A prep pass
writes Delta = rowsum(dO * O) and the log-sum-exp in the log2 domain; the
dK/dV blocks each take a *unit* of a 64-key tile's items (query head x
live 64-query tile), so a group's query heads spread over several blocks
(about two units per SM), and write fp32 partials that a combine pass
sums in unit order; one block per (query tile, head, batch row) walks the
key tiles for dQ. At D 256 each unit runs as two blocks, one per half of
D of dK and dV. No atomics, so the gradients are bitwise repeatable. P
and dS are rounded to bf16 as product operands, as the forward rounds P.
``flash_attention_bwd_plain`` is the same algorithm in PyTorch (P
recomputed per 64-key tile) at any head dim. ``FlashAttention``, the
autograd function, launches the forward and backward kernels on CUDA
tensors and runs the plain versions on CPU tensors; ``flash_attention``
routes through it whenever grad is enabled and an input requires it.

DTensor inputs (a step on a ``DeviceMesh``) run each rank's local shard
(``_build.on_local_shards``: batch and head shards kept where Q, K and V
share them). A fake tensor takes the kernel path and launches nothing
(``_build``). Each launch reports its FLOPs and bytes (chip_smoke's bound
formulas over the masks' visible pairs) to the cost counters.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128, 256)

# the backward kernels take the forward's head dims (at 256 two blocks
# split D for dK and dV)
BWD_HEAD_DIMS = HEAD_DIMS

# kernel launches since the last reset (the main-path evidence): forward
# launches, and backward calls (each one prep, dK/dV, combine and dQ
# launch)
launches = 0
launches_bwd = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 22 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 34
                 + [ctypes.c_void_p])
_SCRATCH_ARGTYPES = [ctypes.c_int] * 10


def _offset(sq: int, kv_len: int, causal: bool, pos_offset: int) -> int:
    """Absolute position of query row 0: queries align to the last ``sq``
    keys under the causal mask, shifted by ``pos_offset``."""
    return pos_offset + (kv_len - sq if causal else 0)


def visible_pairs(sq: int, kv_len: int, causal: bool, window: int,
                  pos_offset: int) -> int:
    """(query, key) pairs the masks leave visible: each product's work."""
    if not causal:
        return sq * kv_len
    qpos = _offset(sq, kv_len, causal, pos_offset) + np.arange(sq,
                                                               dtype=np.int64)
    hi = np.minimum(qpos + 1, kv_len)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo, 0, None).sum())


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    # fp32, or fp64 for fp64 inputs (gradcheck)
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _visible(k_lo: int, n: int, qpos: torch.Tensor, kv_len: int,
             causal: bool, window: int) -> torch.Tensor:
    """[Sq, n] mask of the keys ``k_lo .. k_lo + n`` each query sees."""
    kpos = k_lo + torch.arange(n, device=qpos.device)
    valid = (kpos < kv_len)[None, :].expand(qpos.shape[0], -1)
    if causal:
        valid = valid & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            valid = valid & (kpos[None, :] > qpos[:, None] - window)
    return valid


def _flash_fwd_plain(q, k, v, *, causal, window, kv_len, pos_offset):
    """(out, lse): the plain forward and each row's natural-log sum of
    exponents ``[B,H,Sq]`` in the compute type."""
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    g = h // vh
    cdt = _compute_dtype(q)
    kv_len = sk if kv_len is None else kv_len
    qpos = _offset(sq, kv_len, causal, pos_offset) + torch.arange(
        sq, device=q.device)
    qf = q.to(cdt).reshape(b, vh, g, sq, d) * (1.0 / math.sqrt(d))
    m = torch.full((b, vh, g, sq), NEG_INF, dtype=cdt, device=q.device)
    l = torch.zeros((b, vh, g, sq), dtype=cdt, device=q.device)
    acc = torch.zeros((b, vh, g, sq, d), dtype=cdt, device=q.device)
    for k_lo in range(0, sk, BLOCK_K):
        kt = k[:, :, k_lo:k_lo + BLOCK_K].to(cdt)
        vt = v[:, :, k_lo:k_lo + BLOCK_K].to(cdt)
        valid = _visible(k_lo, kt.shape[2], qpos, kv_len, causal, window)
        s = torch.einsum("bvgqd,bvkd->bvgqk", qf, kt)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bvgqk,bvkd->bvgqd", p, vt)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = acc / l[..., None]
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, h, sq, d).to(q.dtype), lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_len: int | None = None,
                          pos_offset: int = 0) -> torch.Tensor:
    """PyTorch version of the kernel. A KV tile that the masks leave empty
    for a row is an exact no-op on that row's (m, l, acc), so walking every
    tile equals the kernel's pruned walk."""
    return _flash_fwd_plain(q, k, v, causal=causal, window=window,
                            kv_len=kv_len, pos_offset=pos_offset)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              kv_len: int | None = None,
                              pos_offset: int = 0):
    """PyTorch version of the backward kernels: (dq, dk, dv) from the
    forward's inputs, its output ``o`` and log-sum-exp ``lse``
    (``[B,H,Sq]``) and the output's gradient ``do``. Delta = rowsum(dO *
    O), then per 64-key tile P = exp(S - lse) recomputed under the masks,
    dV = P^T dO, dS = P (dO V^T - Delta), dK = dS^T Q / sqrt(D), and dQ +=
    dS K / sqrt(D), in fp32 (fp64 for fp64 inputs), at any head dim: the
    kernels' reference on the card and the path on the CPU."""
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    g = h // vh
    cdt = _compute_dtype(q)
    kv_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    qpos = _offset(sq, kv_len, causal, pos_offset) + torch.arange(
        sq, device=q.device)
    qf = q.to(cdt).reshape(b, vh, g, sq, d) * scale
    dof = do.to(cdt).reshape(b, vh, g, sq, d)
    lsef = lse.to(cdt).reshape(b, vh, g, sq)[..., None]
    delta = (dof * o.to(cdt).reshape(b, vh, g, sq, d)).sum(-1)[..., None]
    dq = torch.zeros((b, vh, g, sq, d), dtype=cdt, device=q.device)
    dk = torch.zeros((b, vh, sk, d), dtype=cdt, device=q.device)
    dv = torch.zeros((b, vh, sk, d), dtype=cdt, device=q.device)
    for k_lo in range(0, sk, BLOCK_K):
        kt = k[:, :, k_lo:k_lo + BLOCK_K].to(cdt)
        vt = v[:, :, k_lo:k_lo + BLOCK_K].to(cdt)
        valid = _visible(k_lo, kt.shape[2], qpos, kv_len, causal, window)
        s = torch.einsum("bvgqd,bvkd->bvgqk", qf, kt)
        p = torch.where(valid, torch.exp(s - lsef), torch.zeros_like(s))
        dv[:, :, k_lo:k_lo + BLOCK_K] = torch.einsum("bvgqk,bvgqd->bvkd",
                                                     p, dof)
        ds = p * (torch.einsum("bvgqd,bvkd->bvgqk", dof, vt) - delta)
        dk[:, :, k_lo:k_lo + BLOCK_K] = torch.einsum("bvgqk,bvgqd->bvkd",
                                                     ds, qf)
        dq = dq + torch.einsum("bvgqk,bvkd->bvgqd", ds, kt) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_inputs(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not _build.on_kernel_path(t) or t.dtype != torch.bfloat16 \
                or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
        _build.require_vector_aligned(name, t)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_len: int | None = None,
                         pos_offset: int = 0) -> torch.Tensor:
    """Launch the Hopper kernel. Inputs may be strided views (the prefill
    passes ``[B,S,H,D]`` projections transposed to ``[B,H,S,D]``); only D
    must be unit-stride, and the 16-byte copies need each input 16-byte
    aligned with strides in multiples of 8 elements. The output is
    allocated ``[B,Sq,H,D]``-contiguous and returned as its ``[B,H,Sq,D]``
    view."""
    return _flash_fwd_cuda(q, k, v, None, causal=causal, window=window,
                           kv_len=kv_len, pos_offset=pos_offset)


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lse: torch.Tensor | None, *, causal: bool, window: int,
                    kv_len: int | None, pos_offset: int) -> torch.Tensor:
    """``flash_attention_cuda`` that also writes each row's fp32
    log-sum-exp into ``lse`` (contiguous ``[B,H,Sq]``, the backward's
    input) where it is given; with ``None`` the kernel computes exactly
    the serving path's bits."""
    global launches
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    _check_inputs(q=q, k=k, v=v)
    if d not in HEAD_DIMS or k.shape[3] != d or v.shape != k.shape \
            or h % vh:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (head_dim in "
                         f"{HEAD_DIMS}, V | H)")
    kv_len = sk if kv_len is None else kv_len
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")
    if max(b, -(-sq // BLOCK_Q)) > 65535:
        raise ValueError(f"batch {b} or {sq} queries beyond the kernel's grid")
    if lse is not None and (lse.shape != (b, h, sq) or lse.dtype
                            != torch.float32 or not lse.is_contiguous()):
        raise ValueError(f"lse: need contiguous fp32 {(b, h, sq)}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    ints = (b, h, vh, sq, sk, d, kv_len, int(causal), window,
            _offset(sq, kv_len, causal, pos_offset), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    if max(abs(i) for i in ints) >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    pairs = visible_pairs(sq, kv_len, causal, window, pos_offset)
    cost = (4 * b * h * pairs * d,
            2 * (2 * q.numel() + k.numel() + v.numel())
            + (0 if lse is None else 4 * lse.numel()))
    if _build.is_fake(q):
        _build.report("flash_attention", *cost)
        return out
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *ints,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    launches += 1
    _build.report("flash_attention", *cost)
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             kv_len: int | None = None,
                             pos_offset: int = 0):
    """Launch the backward kernels: ``(dq, dk, dv)``, each allocated
    sequence-major (``[B,S,heads,D]``) and returned as its ``[B,heads,S,D]``
    view, as the forward returns its output. Inputs as the forward takes
    them (the tensor copies need the same 16-byte alignment); ``do`` is
    copied to a contiguous tensor only where its strides do not suit them.
    The scratch (the prep rows and the fp32 partials of dK and dV) is
    allocated here, sized by the library for the call."""
    global launches_bwd
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    if do.stride(-1) != 1 or (not _build.is_fake(do)
                              and do.data_ptr() % 16) or any(
            st * do.element_size() % 16 for st in do.stride()[:-1]):
        do = do.contiguous()
    _check_inputs(q=q, k=k, v=v, o=o, do=do)
    if d not in BWD_HEAD_DIMS or k.shape[3] != d or v.shape != k.shape \
            or h % vh or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (backward "
                         f"head_dim in {BWD_HEAD_DIMS}; V | H; o and do "
                         f"shaped as q)")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse: need contiguous fp32 {(b, h, sq)}")
    kv_len = sk if kv_len is None else kv_len
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")
    if max(b * vh, h) > 65535:
        raise ValueError(f"batch {b} x {vh} KV heads or {h} heads beyond "
                         f"the kernels' grid")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, vh, d), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    ints = (b, h, vh, sq, sk, d, kv_len, int(causal), window,
            _offset(sq, kv_len, causal, pos_offset),
            *(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    if max(abs(i) for i in ints) >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    # five products (QK^T, dO V^T, P^T dO, dS^T Q, dS K); q, o, dq, k, v,
    # dk, dv, do and the log-sum-exp each read or written once
    pairs = visible_pairs(sq, kv_len, causal, window, pos_offset)
    cost = (10 * b * h * pairs * d,
            2 * (3 * q.numel() + 2 * (k.numel() + v.numel()) + do.numel())
            + 4 * lse.numel())
    if _build.is_fake(q):
        _build.report("flash_attention_bwd", *cost)
        return dq, dk, dv
    lib = _build.load("flash_attention")
    size = lib.flash_attention_bwd_scratch_bytes
    size.argtypes, size.restype = _SCRATCH_ARGTYPES, ctypes.c_longlong
    fn = lib.flash_attention_bwd_bf16
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        # the prep rows (Delta, log-sum-exp) and the dK/dV units' partials;
        # the unit count follows the shape and the card's SM count
        scratch = torch.empty(size(*ints[:10]), dtype=torch.uint8,
                              device=q.device)
        err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, scratch, dq,
                                          dk, dv)),
                 *ints, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention backward launch")
    launches_bwd += 1
    _build.report("flash_attention_bwd", *cost)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient. Saves q, k, v, the output and
    the log-sum-exp. On CUDA tensors the forward and the backward launch
    their kernels (and raise if a launch fails); on CPU tensors both run
    their plain versions. Nothing falls back from one to the other."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, pos_offset):
        kw = dict(causal=causal, window=window, kv_len=kv_len,
                  pos_offset=pos_offset)
        if _build.on_kernel_path(q):
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            out = _flash_fwd_cuda(q, k, v, lse, **kw)
        elif q.device.type == "cpu":
            out, lse = _flash_fwd_plain(q, k, v, **kw)
        else:
            raise ValueError(f"flash_attention: no kernel for {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if _build.on_kernel_path(q) \
            else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None,
                    pos_offset: int = 0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,V,Sk,D], V | H. Returns [B,H,Sq,D],
    differentiable (``FlashAttention``) where grad is enabled and an input
    requires it; DTensors give a DTensor, computed on the local shards."""
    if isinstance(q, DTensor):
        return _build.on_local_shards(
            flash_attention, q, k, v, align_heads=True, causal=causal,
            window=window, kv_len=kv_len, pos_offset=pos_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, kv_len,
                                    pos_offset)
    kw = dict(causal=causal, window=window, kv_len=kv_len,
              pos_offset=pos_offset)
    if _build.on_kernel_path(q):
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_plain(q, k, v, **kw)


def flash_attention_padded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, **kw) -> torch.Tensor:
    """``flash_attention`` at any head dim up to the largest the kernels
    take: on the kernel path a head dim they lack (h2o-danube-3-4b's 120)
    runs zero-padded to the next one, Dp. Padding leaves every score
    unchanged but the kernels' 1/sqrt(Dp) scale, so Q is first multiplied
    by sqrt(Dp / D) in fp32 and rounded to bf16 (a rounding the unpadded
    kernel does not make: within the bf16 tolerance). Differentiable: the
    gradient flows back through the scale, the pads and the slice. On CPU
    tensors, and at a head dim the kernels take, it is ``flash_attention``."""
    if isinstance(q, DTensor):
        return _build.on_local_shards(flash_attention_padded, q, k, v,
                                      align_heads=True, **kw)
    d = q.shape[-1]
    if not _build.on_kernel_path(q) or d in HEAD_DIMS or d > HEAD_DIMS[-1]:
        return flash_attention(q, k, v, **kw)
    dp = next(x for x in HEAD_DIMS if x > d)
    qs = (q.float() * math.sqrt(dp / d)).to(q.dtype)
    pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
    return flash_attention(pad(qs), pad(k), pad(v), **kw)[..., :d]
