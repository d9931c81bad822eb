"""Gradient compression for the data-parallel reduction (port of
``repro.training.compression``).

Modes:
  * "none":  fp32 sum (baseline);
  * "bf16":  cast to bf16 before the all-reduce — halves wire bytes;
  * "int8_ef": per-tensor-scale int8 quantization with error feedback. The
             residual (g - dequant(q)) is carried to the next step, so the
             quantization bias vanishes in expectation; the shared scale is
             the group's max, so the int32 sum dequantizes exactly.

The reference runs inside ``shard_map`` over mesh axes (``psum`` /
``pmax``); here the collectives are ``torch.distributed.all_reduce`` (SUM,
MAX) over a process group. ``one_rank_group`` builds the one-rank group a
single card uses, from a ``FileStore`` in a temporary directory (no
network): gloo for CPU tensors, NCCL for CUDA tensors.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.spec import tree_leaves, tree_map

_STORE_DIR: str | None = None


def one_rank_group():
    """The default process group as one rank (initialized on first use):
    ``cpu:gloo,cuda:nccl`` where NCCL is built, else gloo. Its sockets
    stay on the loopback interface."""
    global _STORE_DIR
    if not dist.is_initialized():
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        _STORE_DIR = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store = dist.FileStore(os.path.join(_STORE_DIR, "store"), 1)
        backend = ("cpu:gloo,cuda:nccl"
                   if torch.cuda.is_available() and dist.is_nccl_available()
                   else "gloo")
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return dist.group.WORLD


def destroy_group() -> None:
    """Tear down the group ``one_rank_group`` made and remove its store."""
    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def reduce_gradients(grads: Any, group=None, mode: str = "none",
                     error_state: Any = None) -> tuple[Any, Any]:
    """All-reduce (mean) gradients across the ranks of ``group``.

    Returns (reduced_grads, new_error_state). error_state is None unless
    mode == "int8_ef"."""
    device = tree_leaves(grads)[0].device
    ones = _sum(torch.ones((), dtype=torch.float32, device=device), group)

    if mode == "none":
        red = tree_map(lambda g: _sum(g.float().clone(), group), grads)
        return tree_map(lambda g: g / ones, red), error_state

    if mode == "bf16":
        red = tree_map(lambda g: _sum(g.to(torch.bfloat16).clone(), group),
                       grads)
        return tree_map(lambda g: g.float() / ones, red), error_state

    if mode == "int8_ef":
        if error_state is None:
            error_state = tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
        red_leaves, err_leaves = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(error_state)):
            gf = g.float() + e
            amax = torch.max(torch.abs(gf))
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            scale = torch.clamp(amax / 127.0, min=1e-12)
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            err_leaves.append(gf - q.float() * scale)
            q_sum = _sum(q.to(torch.int32), group)
            red_leaves.append(q_sum.float() * scale / ones)
        it_r, it_e = iter(red_leaves), iter(err_leaves)
        return (tree_map(lambda _: next(it_r), grads),
                tree_map(lambda _: next(it_e), grads))

    raise ValueError(mode)
