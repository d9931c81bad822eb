"""Analytic per-layer/per-iteration cost model (FLOPs + bytes).

Used by (a) the FlexGen baseline's peak-performance estimator — the thing the
paper shows is inaccurate, (b) the modeled-hardware mode of the performance
analyzer for the paper-figure benchmarks, and (c) MODEL_FLOPS for §Roofline.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeSpec
from repro_torch.models import spec as S
from repro_torch.models import transformer as T


def block_weight_bytes(cfg: ModelConfig, blk: BlockSpec, cross: bool = False
                       ) -> int:
    return S.tree_bytes(T.block_spec(cfg, blk, cross=cross))


def unit_weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of one scan unit (= one pattern period)."""
    cross = cfg.encoder_layers > 0
    return sum(block_weight_bytes(cfg, blk, cross) for blk in cfg.pattern)


def layer_weight_bytes(cfg: ModelConfig) -> int:
    """Average per-layer weight bytes (unit bytes / pattern length)."""
    return unit_weight_bytes(cfg) // len(cfg.pattern)


def _attn_flops(cfg: ModelConfig, b: int, sq: int, skv: int) -> float:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    proj = 2 * b * sq * d * (2 * h * hd + 2 * kv * hd)
    skv_eff = min(skv, cfg.sliding_window) if cfg.sliding_window else skv
    core = 2 * b * h * hd * sq * skv_eff * 2
    return proj + core


def _mlp_flops(cfg: ModelConfig, blk: BlockSpec, b: int, s: int) -> float:
    if cfg.d_ff == 0:
        return 0.0
    nmat = 3 if cfg.gated_mlp else 2
    per_tok = 2 * cfg.d_model * cfg.d_ff * nmat
    if blk.mlp == "moe":
        assert cfg.moe is not None
        return b * s * (per_tok * cfg.moe.top_k
                        + 2 * cfg.d_model * cfg.moe.num_experts)
    return b * s * per_tok


def _mixer_flops(cfg: ModelConfig, blk: BlockSpec, b: int, sq: int,
                 skv: int) -> float:
    if blk.mixer == "attention":
        return _attn_flops(cfg, b, sq, skv)
    d = cfg.d_model
    if blk.mixer == "mamba":
        mc = cfg.mamba
        di = (mc.expand if mc else 2) * d
        ds = mc.d_state if mc else 16
        dtr = max(1, d // 16)
        return b * sq * (2 * d * 2 * di + 2 * di * (dtr + 2 * ds)
                         + 10 * di * ds + 2 * di * d)
    if blk.mixer == "mlstm":
        di = 2 * d
        dh = di // cfg.num_heads
        return b * sq * (2 * d * 2 * di + 3 * 2 * di * dh
                         + 4 * cfg.num_heads * dh * dh + 2 * di * d)
    # slstm
    return b * sq * (2 * d * 4 * d + 2 * d * 4 * d)


def layer_flops(cfg: ModelConfig, b: int, sq: int, skv: int,
                layer_idx: int = 0) -> float:
    blk = cfg.blocks[layer_idx % len(cfg.blocks)]
    return _mixer_flops(cfg, blk, b, sq, skv) + _mlp_flops(cfg, blk, b, sq)


def layer_act_bytes(cfg: ModelConfig, b: int, sq: int, skv: int,
                    layer_idx: int = 0, dtype_bytes: int = 2) -> float:
    """HBM traffic of one layer: weights + activations (+ KV read at decode)."""
    blk = cfg.blocks[layer_idx % len(cfg.blocks)]
    w = block_weight_bytes(cfg, blk, cross=cfg.encoder_layers > 0)
    acts = 6 * b * sq * cfg.d_model * dtype_bytes
    kv_read = 0.0
    if blk.mixer == "attention" and sq == 1:  # decode reads the cache
        skv_eff = min(skv, cfg.sliding_window) if cfg.sliding_window else skv
        kv_read = 2 * b * skv_eff * cfg.num_kv_heads * cfg.resolved_head_dim \
            * dtype_bytes
    return w + acts + kv_read


@dataclasses.dataclass(frozen=True)
class IterationCost:
    flops: float
    bytes: float
    layer_flops: tuple[float, ...]   # per scan layer
    layer_bytes: tuple[float, ...]
    rest_flops: float                # embedding + logits


def iteration_cost(cfg: ModelConfig, b: int, sq: int, skv: int) -> IterationCost:
    lf, lb = [], []
    for j in range(cfg.num_layers):
        lf.append(layer_flops(cfg, b, sq, skv, j))
        lb.append(layer_act_bytes(cfg, b, sq, skv, j))
    rest = 2 * b * sq * cfg.d_model * cfg.padded_vocab()  # logits matmul
    return IterationCost(
        flops=float(sum(lf) + rest), bytes=float(sum(lb)),
        layer_flops=tuple(lf), layer_bytes=tuple(lb), rest_flops=float(rest))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS for §Roofline: 6·N·D for training, 2·N_active·D forward."""
    n = cfg.num_active_params()
    if shape.step == "train":
        return 6.0 * n * shape.tokens
    if shape.step == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per row


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int,
                   virtual_kv: int | None = None, dtype_bytes: int = 2) -> int:
    """Whole-model decode cache bytes (attention KV + SSM states)."""
    vkv = virtual_kv if virtual_kv is not None else cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    total = 0
    for blk in cfg.blocks:
        if blk.mixer == "attention":
            s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
            total += 2 * batch * s * vkv * hd * dtype_bytes
        elif blk.mixer == "mamba":
            mc = cfg.mamba
            di = (mc.expand if mc else 2) * cfg.d_model
            ds = mc.d_state if mc else 16
            total += batch * di * (ds * 4 + (mc.d_conv - 1 if mc else 3) * dtype_bytes)
        elif blk.mixer == "mlstm":
            di = 2 * cfg.d_model
            dh = di // cfg.num_heads
            total += batch * cfg.num_heads * (dh * dh + dh + 1) * 4
        elif blk.mixer == "slstm":
            total += 4 * batch * cfg.d_model * 4
    return int(total)
