"""Elastic resume (port of ``repro.ft.elastic``).

A checkpoint carries no mesh information — leaves are full logical arrays.
``ElasticPlan`` factors a device count into (data, model) as the
reference's does (``for_devices`` is its code). The port runs on one
device, so ``resume`` restores onto one torch device; building a mesh
beyond 1x1 is ROADMAP Queue A item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models.model import build_model


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @staticmethod
    def for_devices(n_devices: int, tp_preference: int = 16) -> "ElasticPlan":
        """Factor n_devices into (data, model), keeping TP stable when the
        device count allows it and degrading gracefully otherwise."""
        tp = tp_preference
        while tp > 1 and n_devices % tp != 0:
            tp //= 2
        return ElasticPlan((n_devices // tp, tp), ("data", "model"))


def resume(cfg: ModelConfig, directory: str,
           device: torch.device | str = "cuda", *, tp_preference: int = 16
           ) -> tuple[Any, dict, ElasticPlan]:
    """Restore the latest checkpoint's parameters onto ``device``.

    Returns (params, extra, plan); the plan is one device's, (1, 1)."""
    step = ckpt.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    plan = ElasticPlan.for_devices(1, tp_preference)
    model = build_model(cfg, tp=plan.mesh_shape[1])
    params, extra = ckpt.restore_checkpoint(directory, step, model.spec,
                                            device)
    return params, extra, plan
