"""Operations a served token needs, from a configuration's sizes.

A matrix product of an [n, k] input with a [k, m] weight is 2 n k m FLOPs.
A token through one decoder layer passes the Q, K, V and output
projections and the MLP (for a mixture of experts, its ``top_k`` experts;
the router is counted too); causal attention over ``ctx`` earlier positions
adds 4 ``ctx`` heads head_dim. The LM head is 2 d_model vocab per position
that computes logits. Norms, RoPE and softmax are left out (under 0.1% at
these widths).
"""
from __future__ import annotations


def _dims(m: dict) -> tuple[int, int, int, int, int]:
    d, h, v = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // h
    return d, h, v, hd, m["d_ff"]


def layer_matmul_params(m: dict) -> float:
    """Weights one token multiplies per layer (active experts only)."""
    d, h, v, hd, f = _dims(m)
    attn = d * h * hd * 2 + d * v * hd * 2
    mats = 3 if m.get("gated_mlp", True) else 2
    moe = m.get("moe")
    if moe:
        return attn + d * moe["num_experts"] + moe["top_k"] * mats * d * f
    return attn + mats * d * f


def attention_flops(m: dict, ctx: float) -> float:
    """Score and value products of one query token over ``ctx`` keys, in
    one layer."""
    _, h, _, hd, _ = _dims(m)
    return 4.0 * h * hd * ctx


def lm_head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def decode_token_flops(m: dict, ctx: int) -> float:
    """One decode token whose query attends ``ctx`` positions (itself
    included)."""
    return (m["num_layers"] * (2.0 * layer_matmul_params(m)
                               + attention_flops(m, ctx))
            + lm_head_flops(m))


def prefill_flops(m: dict, prompt_len: int) -> float:
    """A prompt's real tokens (no padding), causal, with logits at its last
    position only."""
    pairs = prompt_len * (prompt_len + 1) / 2
    return (m["num_layers"] * (2.0 * layer_matmul_params(m) * prompt_len
                               + attention_flops(m, pairs))
            + lm_head_flops(m))
