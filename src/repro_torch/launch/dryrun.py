"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture × input-shape × mesh) cell on the production meshes and record
its costs, memory and collectives.

The reference lowers and compiles each cell with XLA on 512 forced host
devices. The port traces each cell's step once, eagerly, on fake tensors
(``FakeTensorMode``: shapes, no memory) placed as DTensors on a fake 16x16
or 2x16x16 ``DeviceMesh`` (the ``fake`` process-group backend: one process
stands in for rank 0), under ``hlo_costs.CostCounter``. Sharding mismatches,
ops DTensor cannot place and kernel shape limits all fail here. The
hand-written kernels take their fake path: checked, counted, not launched.

Each cell records the traced costs per device and the reference's
pure-Python meta: ``offload`` (``memory_report``), ``cache_bytes_global``,
``param_bytes_global`` and ``model_flops_global``. XLA's
``memory_analysis`` has no counterpart: argument and output bytes are the
local shards' exactly, and ``peak_live_bytes`` is the arguments plus the
largest live set of op outputs seen while tracing (a tensor counts from the
op that made it until it is collected; views and in-place results count
nothing), not an allocator's peak.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape decode_32k --mesh both --offload-interval 4
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES, cell_is_runnable,
                                 get_config, get_shape)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import costs
from repro_torch.core.interval import NO_OFFLOAD, OffloadPlan
from repro_torch.core.memory_manager import (OffloadRuntime,
                                             offload_memory_kind_fn)
from repro_torch.launch import hlo_costs
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import spec as S
from repro_torch.models.frontends import encoder_len
from repro_torch.models.model import build_model
from repro_torch.models.transformer import pattern_info
from repro_torch.sharding.rules import make_rules, mesh_axes, sharding_context
from repro_torch.training.train_loop import (TrainConfig, build_train_step,
                                             opt_state_spec)

# the fake tensors' device: the step's code path is the card's (the kernels
# take their fake path on any fake tensor), and autograd on fake tensors
# needs a device this build of PyTorch has
DEVICE = "cpu"


def collective_bytes(costs_: hlo_costs.HloCosts) -> dict:
    """Per-device wire bytes by collective kind (ring-model factors), with
    their total, and the count of each kind, in the reference's layout."""
    return {"bytes": {**{k: int(v) for k, v in
                         costs_.collective_bytes.items()},
                      "total": int(costs_.collective_total)},
            "count": dict(costs_.collective_count)}


def _local_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local shard)."""
    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def cell_meta(cfg: ModelConfig, shape: ShapeSpec, mesh,
              interval: int = NO_OFFLOAD) -> dict:
    """The cell's pure-Python meta, the reference's: the offload plan's
    ``memory_report`` (prefill, decode), the global cache bytes (decode),
    the global parameter bytes and the model FLOPs. ``mesh`` may be a
    ``MeshShape``: only its model axis (the KV replication) is read."""
    model = build_model(cfg, tp=mesh_axes(mesh)["model"])
    meta: dict[str, Any] = {}
    if shape.step != "train":
        rt = OffloadRuntime(model=model,
                            plan=OffloadPlan(pattern_info(cfg)[1], interval),
                            device=DEVICE)
        meta["offload"] = rt.memory_report()
    if shape.step == "decode":
        meta["cache_bytes_global"] = S.tree_bytes(model.cache_spec(
            shape.global_batch, shape.seq_len, encoder_len(cfg, shape)))
    meta["param_bytes_global"] = S.tree_bytes(model.spec)
    meta["model_flops_global"] = costs.model_flops(cfg, shape)
    return meta


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, interval: int,
               unroll_decode: bool = False,
               fake_mode: FakeTensorMode | None = None
               ) -> tuple[Any, tuple, dict]:
    """Returns (fn, example_args (fake DTensors), meta). ``unroll_decode``
    is the reference's flag: the port's stacks are Python loops, so every
    decode is unrolled already and the flag only labels the cell."""
    fm = fake_mode or FakeTensorMode()
    rules = make_rules(cfg, mesh, step=shape.step,
                       global_batch=shape.global_batch)
    model = build_model(cfg, tp=mesh_axes(mesh)["model"])
    ins = input_specs(cfg, shape, mesh, rules, fm, DEVICE)
    meta = cell_meta(cfg, shape, mesh, interval)

    if shape.step == "train":
        params = S.abstract_with_sharding(model.spec, mesh, rules, fm,
                                          device=DEVICE)
        opt = S.abstract_with_sharding(opt_state_spec(model), mesh, rules,
                                       fm, device=DEVICE)
        step = build_train_step(model, TrainConfig())

        def fn(params, opt_state, batch):
            with sharding_context(mesh, rules):
                return step(params, opt_state, batch)

        return fn, (params, opt, ins), meta

    plan = OffloadPlan(pattern_info(cfg)[1], interval)
    # the walk without the weight ring: the copy of a group's offloaded
    # unit is host-to-device traffic, which the reference's dry run does
    # not count either
    rt = OffloadRuntime(model=model, plan=plan, device=DEVICE)
    params = S.abstract_with_sharding(rt.spec_split(), mesh, rules, fm,
                                      offload_memory_kind_fn, DEVICE)

    if shape.step == "prefill":
        def fn(params, inputs):
            with sharding_context(mesh, rules):
                return rt.prefill(params, inputs, cache_len=shape.seq_len)

        return fn, (params, ins), meta

    enc = encoder_len(cfg, shape)
    cspec = rt.cache_spec_split(shape.global_batch, shape.seq_len, enc)
    caches = S.abstract_with_sharding(cspec, mesh, rules, fm, device=DEVICE)

    def fn(params, tokens, pos, caches, enc_pos=None):
        with sharding_context(mesh, rules):
            return rt.decode_step(params, tokens, pos, caches, enc_pos)

    args = (params, ins["tokens"], ins["pos"], caches)
    if "enc_pos" in ins:
        args = args + (ins["enc_pos"],)
    return fn, args, meta


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, mesh_name: str,
             interval: int = NO_OFFLOAD, verbose: bool = True,
             unroll_decode: bool = False) -> dict:
    t0 = time.time()
    res: dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "interval": None if interval >= NO_OFFLOAD else interval,
        "unroll_decode": unroll_decode or None,
    }
    try:
        fm = FakeTensorMode()
        fn, args, meta = build_cell(cfg, shape, mesh, interval,
                                    unroll_decode, fm)
        ndev = mesh.size()
        arg_bytes = _local_bytes(args)
        with fm, hlo_costs.CostCounter(default_group=ndev) as cc:
            out = fn(*args)
        hc = cc.costs()
        res.update({
            "ok": True,
            "trace_s": round(time.time() - t0, 1),
            "flops_per_device": hc.flops,
            "kernel_flops_per_device": hc.kernel_flops,
            "kernel_calls": hc.kernel_calls,
            "bytes_accessed_per_device": hc.hbm_bytes_native,
            "bytes_accessed_as_traced": hc.hbm_bytes,
            "collectives": collective_bytes(hc),
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": _local_bytes(out),
                "peak_live_bytes": arg_bytes + cc.peak_live,
                "peak_kind": "live-set tracker (arguments + op outputs "
                             "alive at once while tracing)",
            },
            **meta,
        })
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        res.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-8000:]})
    res["wall_s"] = round(time.time() - t0, 1)
    if verbose:
        stat = "OK " if res.get("ok") else "FAIL"
        print(f"[{stat}] {cfg.name:24s} {shape.name:12s} {mesh_name:8s} "
              f"wall={res['wall_s']:7.1f}s "
              + (f"peak={res['memory']['peak_live_bytes']/2**30:.2f}GiB "
                 f"coll={res['collectives']['bytes']['total']/2**30:.2f}GiB"
                 if res.get("ok") else res["error"][:160]),
              flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--offload-interval", type=int, default=0,
                    help="also trace the offloaded variant at this interval")
    ap.add_argument("--unroll-decode", action="store_true",
                    help="the reference's decode-unroll flag; the port's "
                         "decode is a Python loop, so it only labels cells")
    ap.add_argument("--out", default="chiprun_out/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(LM_SHAPES)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("16x16", False))
    if args.mesh in ("multi", "both"):
        meshes.append(("2x16x16", True))

    t_start = time.time()
    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            shape = get_shape(shape_name)
            ok, why = cell_is_runnable(cfg, shape)
            if not ok:
                results.append({"arch": arch, "shape": shape_name,
                                "skipped": why})
                print(f"[SKIP] {arch:24s} {shape_name:12s} {why}", flush=True)
                continue
            for mesh_name, multi in meshes:
                mesh = make_production_mesh(multi_pod=multi)
                results.append(run_cell(cfg, shape, mesh, mesh_name,
                                        unroll_decode=args.unroll_decode))
                if args.offload_interval and shape.step != "train":
                    results.append(run_cell(cfg, shape, mesh, mesh_name,
                                            interval=args.offload_interval))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_fail = sum(1 for r in results if r.get("ok") is False)
    n_skip = sum(1 for r in results if "skipped" in r)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"-> {args.out} (host CPU time {time.time() - t_start:.1f} s)")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
