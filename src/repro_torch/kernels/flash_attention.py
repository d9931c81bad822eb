"""Flash attention forward (prefill): the Hopper kernel's wrapper and its
plain version.

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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches since the last reset (the main-path evidence)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 22 + [ctypes.c_void_p]


def _offset(sq: int, kv_len: int, causal: bool, pos_offset: int) -> int:
    """Absolute position of query row 0: queries align to the last ``sq``
    keys under the causal mask, shifted by ``pos_offset``."""
    return pos_offset + (kv_len - sq if causal else 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          kv_len: int | None = None,
                          pos_offset: int = 0) -> torch.Tensor:
    """PyTorch version of the kernel. A KV tile that the masks leave empty
    for a row is an exact no-op on that row's (m, l, acc), so walking every
    tile equals the kernel's pruned walk."""
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    g = h // vh
    kv_len = sk if kv_len is None else kv_len
    qpos = _offset(sq, kv_len, causal, pos_offset) + torch.arange(
        sq, device=q.device)
    qf = q.float().reshape(b, vh, g, sq, d) * (1.0 / math.sqrt(d))
    m = torch.full((b, vh, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, vh, g, sq), device=q.device)
    acc = torch.zeros((b, vh, g, sq, d), device=q.device)
    for k_lo in range(0, sk, BLOCK_K):
        kt = k[:, :, k_lo:k_lo + BLOCK_K].float()
        vt = v[:, :, k_lo:k_lo + BLOCK_K].float()
        kpos = k_lo + torch.arange(kt.shape[2], device=q.device)
        valid = (kpos < kv_len)[None, :].expand(sq, -1)
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                valid = valid & (kpos[None, :] > qpos[:, None] - window)
        s = torch.einsum("bvgqd,bvkd->bvgqk", qf, kt)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bvgqk,bvkd->bvgqd", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)


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
    global launches
    b, h, sq, d = q.shape
    vh, sk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"{name}: need a bf16 CUDA tensor with unit "
                             f"stride along head_dim, got {t.dtype} "
                             f"{t.device} strides {t.stride()}")
        _build.require_vector_aligned(name, t)
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
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    ints = (b, h, vh, sq, sk, d, kv_len, int(causal), window,
            _offset(sq, kv_len, causal, pos_offset), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    if max(abs(i) for i in ints) >= 2**31:
        raise ValueError("sizes or strides beyond the kernel's 32-bit ints")
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd_bf16
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ints,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: int | None = None,
                    pos_offset: int = 0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,V,Sk,D], V | H. Returns [B,H,Sq,D]."""
    kw = dict(causal=causal, window=window, kv_len=kv_len,
              pos_offset=pos_offset)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_plain(q, k, v, **kw)
