"""The plain reference against the port at a reduced size on the CPU (the
port's kernels run their plain versions there), on the benchmark's own
seeded weights; and the weight layout against the program's parameter
tree."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.common import serve, weights
from bench.reference import model as reference

DATA = Path(__file__).resolve().parent / "data" / "configs"


@pytest.mark.parametrize("name,seed", [("tiny-dense", 2**31 + 5),
                                       ("tiny-dense", 5), ("tiny-moe", 5)])
def test_reference_matches_the_port(name, seed):
    """The port computes in bf16, the reference in fp32: logits of about 4
    agree within 0.1, and where the two pick different tokens the port's
    lies within 0.1 of the reference's best. (With seed 2**31 + 5 the
    tiny MoE's bf16 router sends a few tokens to another expert at a
    near-tie, which moves their logits by up to 2.6: a served token's gap
    is the number the benchmark compares for that reason.)"""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    m = json.loads((DATA / f"{name}.json").read_text())["model"]
    model = build_model(serve.model_config(m))
    params = weights.make(m, seed, "cpu")
    toks = np.random.default_rng(0).integers(0, m["vocab_size"], 40)
    hidden, _, _, _ = model.forward(
        params, {"tokens": torch.as_tensor(toks)[None]})
    port = T.lm_logits(model.cfg, params, hidden)[0].float()
    ref = reference.logits_at(m, seed, [(toks, list(range(40)))], "cpu")[0]
    assert (port - ref).abs().max().item() < 0.1
    picked = ref.gather(1, port.argmax(-1)[:, None])[:, 0]
    assert (ref.max(-1).values - picked).max().item() < 0.1


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_weight_layout_is_the_programs(name):
    from repro_torch.models.model import build_model
    m = json.loads((DATA / f"{name}.json").read_text())["model"]
    model = build_model(serve.model_config(m))
    params = weights.make(m, 3, "cpu")
    assert serve._shapes(params) == serve._shapes(model.spec)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(params))


def test_weights_repeat_from_the_seed():
    m = json.loads((DATA / "tiny-dense.json").read_text())["model"]
    a = weights.make(m, 2**33 + 1, "cpu")
    b = weights.make(m, 2**33 + 1, "cpu")
    c = weights.make(m, 2**33 + 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_fp8_control_departs_from_the_reference():
    m = json.loads((DATA / "tiny-dense.json").read_text())["model"]
    toks = np.random.default_rng(1).integers(0, m["vocab_size"], 30)
    seqs = [(toks, list(range(30)))]
    ref = reference.logits_at(m, 7, seqs, "cpu")[0]
    ctl = reference.logits_at(m, 7, seqs, "cpu", quant="fp8")[0]
    err = (ref - ctl).abs().max().item()
    assert 0.05 < err < 2.0


def _leaves(t):
    if isinstance(t, torch.Tensor):
        return [t]
    vals = t.values() if isinstance(t, dict) else t
    return [x for v in vals for x in _leaves(v)]
