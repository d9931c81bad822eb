"""AdamW (port of ``repro.training.optimizer``). Parameters stay in the
model dtype (bf16); first/second moments are fp32; the update is computed
in fp32 and cast back.

Plain tensor code on the parameter tree (the reference's is plain jnp, not
a Pallas kernel). Unlike the reference's pure function, ``adamw_update``
updates the parameters and both moments **in place** and returns the same
trees: at qwen2.5-3b's width a functional update would hold a second copy
of the 6.2 GB parameters and 24.7 GB of moments. Scalars (the step count,
the learning rate, the clip scale) stay on the device, so a step never
waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.spec import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; fp32 like the
    reference's."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, decayed)


def init_opt_state(params: Any) -> dict:
    # zeros_like: a DTensor parameter's moments share its placement
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping, in place (module note).
    Returns (params, state, {"grad_norm", "lr"}), the same trees."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, count)
    c = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        step = torch.div(m, bc1)
        step.div_(torch.div(v, bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        step.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf.sub_(step.mul_(lr)))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
