"""Published peaks of one NVIDIA H100 SXM and the roofline arithmetic.

Frozen copies, so that a change to the program cannot move the yardstick:
``HBM_BYTES_S``, ``BF16_FLOPS_S`` and ``bound`` from ``chip_smoke.py``
(lines 211-212 and 545-550), and the operation and byte counts of the
flash prefill and paged decode kernels from its ``check_d256`` rows
(``chip_smoke.py`` lines 582-585 and 621-624). Peaks: NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12           # 80 GB of HBM3
BF16_FLOPS_S = 989e12           # dense bf16 tensor-core rate


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in seconds, and what bounds it:
    the larger of bytes over the memory rate and operations over the bf16
    tensor rate."""
    return max((nbytes / HBM_BYTES_S, "bytes"),
               (flops / BF16_FLOPS_S, "operations"))


def flash_prefill_cost(seq: int, heads: int, kv_heads: int, head_dim: int,
                       batch: int = 1) -> tuple[float, float]:
    """(bytes, FLOPs) of one causal flash-attention call over ``seq``
    positions: Q read and O written, K and V read once, bf16; 4 FLOPs per
    (query, key) pair and head dim over the causal pairs."""
    q = batch * heads * seq * head_dim
    kv = batch * kv_heads * seq * head_dim
    pairs = seq * (seq + 1) // 2
    return 2.0 * (2 * q + 2 * kv), 4.0 * batch * heads * pairs * head_dim


def paged_decode_cost(context_lens, rows: int, heads: int, kv_heads: int,
                      head_dim: int, table_pages: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one paged decode-attention call: each context
    token's K and V read once (bf16), one query and one output row per
    batch row and head, the block table and the context lengths (int32);
    4 FLOPs per (query head, context token, head dim)."""
    tokens = float(sum(int(c) for c in context_lens))
    nbytes = (tokens * kv_heads * head_dim * 4 + 2 * rows * heads * head_dim
              * 2 + rows * table_pages * 4 + rows * 4)
    return nbytes, 4.0 * tokens * heads * head_dim
