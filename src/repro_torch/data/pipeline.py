"""Deterministic synthetic data (port of ``repro.data.pipeline``): the
training token stream and the serving request stream.

The paper's workload is a "randomly designed dataloader" (§5.1) — workload
content does not change the system's behaviour (deterministic layer times),
so a seeded stream is the faithful substrate. Batches come from numpy's
Philox keyed by (seed, step, first row), as in the reference, so the port's
batches equal the reference's bit for bit. On a ``DeviceMesh`` each leaf is
a DTensor split by rows over the data axes (``("pod", "data")`` or
``("data",)``), float leaves in bf16, as the reference assembles its global
array (one process builds the whole batch and places it).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.frontends import frontend_positions
from repro_torch.sharding.rules import placements


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # synthetic request mix for serving benches
    mean_prompt_len: int = 256
    mean_output_len: int = 64


class SyntheticTokenStream:
    """Deterministic [B, S] token/label batches for training."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, dcfg: DataConfig,
                 mesh: DeviceMesh | None = None,
                 device: torch.device | str = "cuda"):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self.mesh = mesh
        self.device = torch.device(mesh.device_type if mesh is not None
                                   else device)
        self.n_front = frontend_positions(cfg, shape)

    def _host_batch(self, step: int, lo: int, hi: int) -> dict[str, np.ndarray]:
        """Rows [lo, hi) of the global batch at ``step``."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.Generator(np.random.Philox(
            key=self.dcfg.seed, counter=[step, lo, 0, 0]))
        s_tok = shape.seq_len - (self.n_front
                                 if cfg.frontend and cfg.family != "audio" else 0)
        toks = rng.integers(0, cfg.vocab_size, size=(hi - lo, s_tok + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.encoder_layers > 0:
            out["enc_embeds"] = rng.standard_normal(
                (hi - lo, shape.seq_len, cfg.d_model), dtype=np.float32) * 0.02
        elif cfg.frontend is not None:
            out["frontend_embeds"] = rng.standard_normal(
                (hi - lo, self.n_front, cfg.d_model), dtype=np.float32) * 0.02
        return out

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        host = self._host_batch(step, 0, self.shape.global_batch)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in host.items()}
        if self.mesh is None:
            return out
        dp = (("pod", "data") if "pod" in self.mesh.mesh_dim_names
              else ("data",))
        pl = list(placements((dp,), self.mesh))
        return {k: distribute_tensor(
            v.to(torch.bfloat16) if v.is_floating_point() else v,
            self.mesh, pl) for k, v in out.items()}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class SyntheticRequest:
    rid: int
    prompt_len: int
    max_new_tokens: int
    ttft_slo_s: float
    tpot_slo_s: float
    arrival_s: float


def request_stream(dcfg: DataConfig, n: int, *, ttft_slo_s: float,
                   tpot_slo_s: float, rate_per_s: float = 4.0
                   ) -> list[SyntheticRequest]:
    """Poisson arrivals with geometric lengths (paper §5.1 style)."""
    rng = np.random.Generator(np.random.Philox(key=dcfg.seed + 1))
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_per_s)
        out.append(SyntheticRequest(
            rid=i,
            prompt_len=int(np.clip(rng.geometric(
                1.0 / dcfg.mean_prompt_len), 8, 4096)),
            max_new_tokens=int(np.clip(rng.geometric(
                1.0 / dcfg.mean_output_len), 4, 1024)),
            ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s, arrival_s=t))
    return out
