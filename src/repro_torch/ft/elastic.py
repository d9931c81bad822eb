"""Elastic re-meshing (port of ``repro.ft.elastic``): resume a job on a
different device count.

A checkpoint carries no mesh information — leaves are full logical arrays.
On restart we rebuild the mesh from whatever devices exist, re-resolve
shardings through the same rules, and restore. The data-parallel axis
absorbs the size change; tensor-parallel degree is kept stable by
preference (the rules' divisibility fallback guards impossible splits).
``ElasticPlan`` is the reference's. The port's process holds one device per
rank, so the devices are the default process group's ranks (one, where no
group runs).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import spec as S
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import make_rules


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

    def make_mesh(self):
        from repro_torch.launch.mesh import make_mesh_compat
        return make_mesh_compat(self.mesh_shape, self.axis_names)


def resume(cfg: ModelConfig, directory: str,
           device: torch.device | str = "cuda", *, tp_preference: int = 16
           ) -> tuple[Any, dict, Any]:
    """Restore the latest checkpoint onto a mesh of ``device``'s type built
    from the ranks that exist (the card unless the caller asks for the
    CPU). Returns (params as DTensors, extra, mesh)."""
    from repro_torch.launch.mesh import make_mesh_compat

    step = ckpt.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    plan = ElasticPlan.for_devices(n, tp_preference)
    mesh = make_mesh_compat(plan.mesh_shape, plan.axis_names,
                            torch.device(device).type)
    rules = make_rules(cfg, mesh)
    model = build_model(cfg, tp=mesh.shape[1])
    shardings = S.shardings(model.spec, mesh, rules)
    params, extra = ckpt.restore_checkpoint(directory, step, model.spec,
                                            shardings=shardings)
    return params, extra, mesh
