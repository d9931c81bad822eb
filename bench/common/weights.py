"""Seeded weights, made on the device in the type they are served in.

The tree follows the layout the served program takes (its parameter
names, leaves stacked over the layers): ``embed`` [V, D]; per layer
``norm1``, ``attn`` (``wq`` [D, H, hd], ``wk`` / ``wv`` [D, KV, hd],
``wo`` [H, hd, D]), ``norm2`` and ``mlp`` (dense ``w1`` / ``w3`` [D, F],
``w2`` [F, D]; or a mixture of experts: ``router`` [D, E], ``w1`` / ``w3``
[E, D, F], ``w2`` [E, F, D]); ``final_norm``; ``lm_head`` [D, V]. A norm
is a ``scale`` of ones (and a ``bias`` of zeros for a layer norm); every
matrix is N(0, 1) over its fan-in's square root, drawn in bf16 from one
``torch.Generator`` seeded with the run's seed, leaf after leaf in this
order, in calls of at most 2**30 values. The reference makes the same
tree again from the same seed.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30


def layout(m: dict) -> dict:
    """Leaf name -> (shape, fan-in or 0 for ones / -1 for zeros), for a
    decoder of the sizes in ``m`` (a configuration's ``model`` group)."""
    d, h, kv, f = m["d_model"], m["num_heads"], m["num_kv_heads"], m["d_ff"]
    hd = m.get("head_dim") or d // h
    r, vocab = m["num_layers"], m["vocab_size"]
    norm = {"scale": ((d,), 0)}
    if m.get("norm", "rmsnorm") == "layernorm":
        norm["bias"] = ((d,), -1)
    stack = lambda tree: {k: ((r, *s), fan) for k, (s, fan) in tree.items()}
    attn = {"wq": ((d, h, hd), d), "wk": ((d, kv, hd), d),
            "wv": ((d, kv, hd), d), "wo": ((h, hd, d), h * hd)}
    moe = m.get("moe")
    if moe:
        e = moe["num_experts"]
        mlp = {"router": ((d, e), d), "w1": ((e, d, f), d),
               "w2": ((e, f, d), f), "w3": ((e, d, f), d)}
    else:
        mlp = {"w1": ((d, f), d), "w2": ((f, d), f), "w3": ((d, f), d)}
    return {"embed": ((vocab, d), d),
            "blocks": [{"norm1": stack(norm), "attn": stack(attn),
                        "norm2": stack(norm), "mlp": stack(mlp)}],
            "final_norm": dict(norm),
            "lm_head": ((d, vocab), d)}


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _make(tree, gen: torch.Generator, device) -> object:
    if _is_leaf(tree):
        shape, fan = tree
        if fan == 0:
            return torch.ones(shape, dtype=torch.bfloat16, device=device)
        if fan < 0:
            return torch.zeros(shape, dtype=torch.bfloat16, device=device)
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        flat = out.view(-1)
        for s in range(0, flat.numel(), CHUNK):
            part = flat[s:s + CHUNK]
            torch.randn(part.numel(), generator=gen, out=part)
        return out.mul_(1.0 / math.sqrt(fan))
    if isinstance(tree, dict):
        return {k: _make(v, gen, device) for k, v in tree.items()}
    return [_make(v, gen, device) for v in tree]


def make(m: dict, seed: int, device) -> dict:
    """The whole tree for ``m`` from ``seed``, on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    return _make(layout(m), gen, device)
