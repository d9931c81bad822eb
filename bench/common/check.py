"""How ``correct`` is decided: the served tokens of a sample of finished
requests, held against the plain reference.

The sample is drawn from the seed among the requests due in the window
that finished: the longest (prompt and output) first, then others in the
seed's order until it holds both ``min_tokens`` served tokens and
``min_requests`` requests (or every finished request), so that it covers
many of the slots the window kept busy. The reference runs once over each prompt with its served tokens
and gives, at each served position, float32 logits; a served token's gap is
how far its logit lies below the reference's best there (0 when the
reference agrees). The number compared is the configuration's
``check.statistic`` of the gaps over the sample: the widest gap, or for a
mixture of experts the mean gap (a router near-tie that bf16 breaks the
other way sends a token to another expert and moves its logits by up to
about 1.4, in the program and in the control alike, so the widest gap
cannot tell them apart).
The control puts the reference, computed with float8 weights, in the
program's place: at each of the same positions its first token's gap.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import model as reference


def sample(tracked: list, seed: int, min_tokens: int, min_requests: int
           ) -> list:
    done = [t for t in tracked if t.in_window and t.finished]
    if not done:
        return []
    size = lambda t: len(t.spec.prompt) + len(t.req.generated)
    longest = max(done, key=size)
    rng = np.random.Generator(np.random.Philox(key=seed + 1))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, tokens = [longest], len(longest.req.generated)
    for t in rest:
        if tokens >= min_tokens and len(out) >= min_requests:
            break
        out.append(t)
        tokens += len(t.req.generated)
    return out


def sequences(picked: list) -> list[tuple[np.ndarray, list[int]]]:
    """Each picked request's prompt and served tokens (the last served
    token is never fed back) and the positions whose logits chose the
    served tokens."""
    seqs = []
    for t in picked:
        gen = [int(x) for x in t.req.generated]
        toks = np.concatenate([t.spec.prompt, np.asarray(gen[:-1], np.int32)])
        first = len(t.spec.prompt) - 1
        seqs.append((toks, list(range(first, first + len(gen)))))
    return seqs


def gaps(ref_logits: list[torch.Tensor], chosen: list[torch.Tensor]
         ) -> torch.Tensor:
    """Per position, the reference's best logit minus its logit of the
    chosen token."""
    out = []
    for lg, tok in zip(ref_logits, chosen):
        tok = tok.to(lg.device).long()
        out.append(lg.max(dim=-1).values
                   - lg.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)


def summary(g: torch.Tensor) -> dict:
    """The widest gap, and beside it the mean, the 90th percentile and the
    share of tokens the reference would not have chosen."""
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "p90_gap": float(torch.quantile(g, 0.9)),
            "tokens": int(g.numel()), "disagree": int((g > 0).sum())}


def served_gap(m: dict, seed: int, picked: list, device) -> dict:
    """The gaps of the picked requests' served tokens."""
    seqs = sequences(picked)
    loads: list = []
    ref = reference.logits_at(m, seed, seqs, device, loads=loads)
    served = [torch.as_tensor([int(x) for x in t.req.generated])
              for t in picked]
    out = summary(gaps(ref, served))
    out["requests"] = len(picked)
    if loads:
        out["max_expert_load"] = max(loads)
    return out


def control_gap(m: dict, seed: int, picked: list, device) -> dict:
    """The control's gaps at the same positions: the float8 reference's
    first token at each, judged by the float32 reference."""
    seqs = sequences(picked)
    ref = reference.logits_at(m, seed, seqs, device)
    ctl = reference.logits_at(m, seed, seqs, device, quant="fp8")
    return summary(gaps(ref, [c.argmax(dim=-1) for c in ctl]))
