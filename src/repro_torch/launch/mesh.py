"""Production mesh builders (port of ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module starts no
process group. A ``DeviceMesh`` needs the default process group, and a
process has one, so the group is chosen to suit the mesh:

* 1x1 on a real backend: ``nccl`` on the card, ``gloo`` on the CPU, world
  size 1 (a one-process group on an in-memory store);
* a larger mesh in one process: the ``fake`` backend, whose collectives
  return at once. It stands in for rank 0 of the mesh when a step is traced
  (``launch.dryrun``); the values it computes are rank 0's local ones.

A mesh larger than the world of a real group raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

REAL_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(size: int, device_type: str,
                         backend: str | None = None) -> str:
    """Start the default process group for a mesh of ``size`` devices of
    ``device_type`` unless one is running; returns its backend. ``backend``
    None picks ``fake`` for a mesh of more than one device and the device's
    real backend for one. A running ``fake`` group smaller than the mesh is
    restarted at the mesh's size; a running real group must be as large as
    the mesh."""
    want = backend or ("fake" if size > 1 else REAL_BACKENDS[device_type])
    if dist.is_initialized():
        have = dist.get_backend()
        if have == "fake" and want == "fake" \
                and dist.get_world_size() < size:
            dist.destroy_process_group()
        else:
            if dist.get_world_size() < size:
                raise ValueError(
                    f"a mesh of {size} devices needs a world of {size} "
                    f"ranks; the {have!r} group has "
                    f"{dist.get_world_size()} (a larger mesh runs in one "
                    f"process only on the fake backend)")
            return have
    if want == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    else:
        if size > 1:
            raise ValueError(
                f"a mesh of {size} devices on the {want!r} backend needs "
                f"{size} processes; this one starts a world of 1")
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    return want


def make_mesh_compat(shape: tuple, axes: tuple, device_type: str = "cuda",
                     backend: str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over
    ``device_type``, starting the default process group it needs."""
    size = math.prod(shape)
    if device_type == "cuda" and not torch.cuda.is_available() \
            and (backend or ("fake" if size > 1 else "nccl")) != "fake":
        raise ValueError("a cuda mesh on a real backend needs a CUDA device")
    ensure_process_group(size, device_type, backend)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods = 512
    chips (pod, data, model). Nothing binds to pod=2 — the same rules extend
    to any pod count. One process holds them on the fake backend, over the
    CPU device type, where a traced step's fake tensors live."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    # one fake world as large as the larger mesh serves both: restarting
    # the group would strand the groups of a mesh made before
    ensure_process_group(2 * 16 * 16, device_type, "fake")
    return make_mesh_compat(shape, axes, device_type, "fake")


def make_mesh_from_spec(spec: str, device_type: str = "cuda",
                        backend: str | None = None) -> DeviceMesh:
    """'16x16' -> (data, model); '2x16x16' -> (pod, data, model);
    '1x1' -> the one-device mesh."""
    dims = tuple(int(x) for x in spec.lower().split("x"))
    if len(dims) == 2:
        axes = ("data", "model")
    elif len(dims) == 3:
        axes = ("pod", "data", "model")
    else:
        raise ValueError(f"mesh spec {spec!r}")
    return make_mesh_compat(dims, axes, device_type, backend)


def destroy() -> None:
    """End the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
