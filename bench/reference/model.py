"""The plain reference: a decoder's forward pass in float32 (TF32 off), in
plain PyTorch, with no kernel, cache or batching of the program.

It follows the layer equations the configuration states: pre-norm blocks
(RMSNorm, or LayerNorm for ``"norm": "layernorm"``; eps 1e-6), RoPE in the
rotate-half form with ``rope_theta``, causal softmax attention with the KV
heads shared by groups of query heads, a SwiGLU MLP (``silu(x w1) * (x
w3)`` then ``w2``) or a mixture of experts (fp32 softmax router, the
``top_k`` experts by probability, their weights renormalised to sum to 1,
every routed token computed: no capacity limit), a final norm and an
untied LM head. Weights are made again from the run's seed
(``bench.common.weights``) and widened to float32 one layer at a time;
sequences run together layer by layer, so that one layer's float32
weights are on the device at a time.

``quant="fp8"`` is the control: every matrix rounded to float8 e4m3 with
one scale per output channel before it is widened, the step below the
bf16 the configuration serves in.
"""
from __future__ import annotations

import math

import torch

from bench.common import weights

EPS = 1e-6


def _fp8(w: torch.Tensor, in_dims: tuple[int, ...]) -> torch.Tensor:
    """``w`` through float8 e4m3 with one scale per output channel (the
    amax over the input dims ``in_dims`` maps to 448)."""
    w = w.float()
    amax = w.abs().amax(dim=in_dims, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _wide(w: torch.Tensor, in_dims: tuple[int, ...], quant: str | None):
    return _fp8(w, in_dims) if quant == "fp8" else w.float()


def _norm(m: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if m.get("norm", "rmsnorm") == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + EPS) * p["scale"].float() \
            + p["bias"].float()
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + EPS) * p["scale"].float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, heads, hd] at positions ``pos`` [T]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal attention of one sequence: q [T, H, hd], k / v [T, KV, hd]."""
    t, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def _mlp(m: dict, p: dict, x: torch.Tensor, quant, loads=None,
         prompts=()) -> torch.Tensor:
    act = torch.nn.functional.silu
    moe = m.get("moe")
    if not moe:
        w1, w2, w3 = (_wide(p[k], (0,), quant) for k in ("w1", "w2", "w3"))
        return (act(x @ w1) * (x @ w3)) @ w2
    router = _wide(p["router"], (0,), quant)
    probs = torch.softmax(x @ router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = moe["top_k"]
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    if loads is not None:
        # the most entries one expert takes from one prompt (the program's
        # padded prefill keeps at most its capacity of them)
        loads.append(max(int(torch.bincount(
            top_i[s:s + n].flatten(), minlength=moe["num_experts"]).max())
            for s, n in prompts))
    y = torch.zeros_like(x)
    for e in range(moe["num_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w1, w2, w3 = (_wide(p[n][e], (0,), quant) for n in ("w1", "w2", "w3"))
        xe = x[rows]
        ye = (act(xe @ w1) * (xe @ w3)) @ w2
        y.index_add_(0, rows, ye * top_p[rows, slot, None])
    return y


@torch.no_grad()
def logits_at(m: dict, seed: int, seqs: list, device, quant: str | None = None,
              loads: list | None = None) -> list[torch.Tensor]:
    """For each ``(tokens, positions)`` in ``seqs``, the float32 logits
    [len(positions), vocab] that the model of sizes ``m`` with seed
    ``seed``'s weights gives at ``positions`` of ``tokens``. For a mixture
    of experts, ``loads`` gathers per layer the most entries one expert
    takes from one prompt (the tokens before the first position)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = weights.make(m, seed, device)
    blocks = w["blocks"][0]
    lens = [len(t) for t, _ in seqs]
    ids = torch.as_tensor([int(x) for t, _ in seqs for x in t],
                          device=device)
    embed = w["embed"]
    x = (_fp8(embed, (1,))[ids] if quant == "fp8" else embed[ids].float())
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    starts = [sum(lens[:i]) for i in range(len(lens))]
    h, kv = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // h
    theta = m.get("rope_theta", 10_000.0)
    for layer in range(m["num_layers"]):
        p = {g: {k: t[layer] for k, t in blocks[g].items()} for g in blocks}
        a = _norm(m, p["norm1"], x)
        wq, wk, wv = (_wide(p["attn"][k], (0,), quant).flatten(1)
                      for k in ("wq", "wk", "wv"))
        q = _rope((a @ wq).view(-1, h, hd), pos, theta)
        k = _rope((a @ wk).view(-1, kv, hd), pos, theta)
        v = (a @ wv).view(-1, kv, hd)
        o = torch.cat([_attention(q[s:s + n], k[s:s + n], v[s:s + n])
                       for s, n in zip(starts, lens)])
        wo = _wide(p["attn"]["wo"], (0, 1), quant).flatten(0, 1)
        x = x + o.flatten(1) @ wo
        x = x + _mlp(m, p["mlp"], _norm(m, p["norm2"], x), quant, loads,
                     [(s, ps[0] + 1) for s, (_, ps) in zip(starts, seqs)])
    x = _norm(m, w["final_norm"], x)
    head = _wide(w["lm_head"], (0,), quant)
    out = [x[s + torch.as_tensor(ps, device=device)] @ head
           for s, (_, ps) in zip(starts, seqs)]
    del w, blocks
    return out
