"""input_specs(): fake-tensor DTensor stand-ins (no memory, placed by the
rules) for every model input of a (arch × shape) cell (port of
``repro.launch.inputs``)."""
from __future__ import annotations

from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.frontends import encoder_len, frontend_positions
from repro_torch.models.spec import fake_dtensor
from repro_torch.sharding.rules import Rules, named_sharding


def input_logical(cfg: ModelConfig, shape: ShapeSpec
                  ) -> dict[str, tuple[tuple[int, ...], tuple, torch.dtype]]:
    """{input name: (global shape, logical axes, dtype)} of the cell's
    step-function inputs (excl. params/caches, built from the model spec
    trees): the reference's shapes, dtypes and axes."""
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    out: dict[str, tuple] = {}
    if shape.step in ("train", "prefill"):
        n_front = frontend_positions(cfg, shape)
        if cfg.encoder_layers > 0:
            out["enc_embeds"] = ((b, encoder_len(cfg, shape), d),
                                 ("batch", None, None), torch.bfloat16)
            s_tok = s
        else:
            if cfg.frontend is not None:
                out["frontend_embeds"] = ((b, n_front, d),
                                          ("batch", None, None),
                                          torch.bfloat16)
            s_tok = s - (n_front if cfg.family != "audio" else 0)
        out["tokens"] = ((b, s_tok), ("batch", None), torch.int32)
        if shape.step == "train":
            out["labels"] = ((b, s_tok), ("batch", None), torch.int32)
    else:  # decode
        out["tokens"] = ((b,), ("batch",), torch.int32)
        out["pos"] = ((b,), ("batch",), torch.int32)
        if cfg.encoder_layers > 0:
            out["enc_pos"] = ((b, encoder_len(cfg, shape)), ("batch", None),
                              torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: Rules,
                fake_mode: FakeTensorMode,
                device: torch.device | str = "cpu") -> dict[str, Any]:
    """Step-function inputs for the cell as fake DTensors on ``mesh``."""
    return {k: fake_dtensor(shp, dt, named_sharding(mesh, rules, shp, lg),
                            fake_mode, device)
            for k, (shp, lg, dt) in input_logical(cfg, shape).items()}
