"""Reduced (smoke-test) variants of every architecture.

Same family/pattern/features, tiny dims: used by CPU smoke tests and
examples. The FULL configs are exercised only via the dry-run
(ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FrontendConfig, MambaConfig, ModelConfig, MoEConfig


def reduce_config(cfg: ModelConfig, *, d_model: int = 64, heads: int = 4,
                  layers: int | None = None, d_ff: int = 128,
                  vocab: int = 512) -> ModelConfig:
    p = len(cfg.pattern)
    if layers is None:
        layers = max(p, 2 * p if p <= 2 else p)
    layers = ((layers + p - 1) // p) * p
    kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
    while heads % kv != 0:
        kv -= 1
    changes: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=d_ff if cfg.d_ff > 0 else 0,
        vocab_size=vocab,
        head_dim=32 if cfg.head_dim else 0,
        sliding_window=8 if cfg.sliding_window else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        param_fsdp=cfg.param_fsdp,
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                                   capacity_factor=cfg.moe.capacity_factor)
    if cfg.mamba is not None:
        changes["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2)
    if cfg.frontend is not None:
        changes["frontend"] = FrontendConfig(kind=cfg.frontend.kind,
                                             num_positions=4)
    return dataclasses.replace(cfg, **changes)
