"""KV-head replication rule (port of ``repro.sharding.rules``).

Only ``virtual_kv_heads`` is needed on one device; logical-axis sharding
constraints are no-ops there and are not ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def virtual_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """Number of *stored* KV heads after replication for tensor parallelism.

    Smallest v with v % kv == 0, v % tp == 0, heads % v == 0 (the standard
    vLLM/MaxText KV replication scheme). Falls back to kv (no expansion) when
    impossible — then attention is not head-sharded on this mesh.
    """
    kv, h = cfg.num_kv_heads, cfg.num_heads
    for mult in range(1, h // kv + 1):
        v = kv * mult
        if v % tp == 0 and h % v == 0:
            return v
    return kv
