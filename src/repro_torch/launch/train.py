"""End-to-end training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck

The reference's flags and output lines, plus ``--device`` (cuda unless the
caller asks for the CPU) and ``--backend``: the seeded token stream, remat,
AdamW, async checkpoints, the watchdog and ``--resume``. ``--mesh`` trains
on a ``DeviceMesh`` with parameters, optimizer state and batches as
DTensors placed by the sharding rules: 1x1 on the device's real backend
(``nccl`` on the card, ``gloo`` on the CPU); any spec with ``--backend
fake``, one process standing in for rank 0 (its collectives return at
once, so its numbers are rank 0's local ones). Without ``--mesh`` the step
runs on plain tensors.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.reduced import reduce_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.watchdog import StepWatchdog, WatchdogConfig
from repro_torch.launch.mesh import REAL_BACKENDS, make_mesh_from_spec
from repro_torch.models import spec as S
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import make_rules, mesh_axes, sharding_context
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import (TrainConfig, build_train_step,
                                             init_train_state, opt_state_spec)


def _scalar(t: torch.Tensor) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--dp-compress", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--mesh", default=None,
                    help="train on a DeviceMesh: 1x1 on a real backend, "
                         "any spec (16x16, 2x16x16) with --backend fake")
    ap.add_argument("--backend", default=None, choices=["fake"],
                    help="the process group for --mesh (default: the "
                         "device's real one, nccl or gloo)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device (pass --device cpu)")

    started = not dist.is_initialized()
    try:
        return _train(ap, args, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(ap, args, device: torch.device) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    mesh = rules = None
    if args.mesh is not None:
        try:
            mesh = make_mesh_from_spec(
                args.mesh, device.type,
                args.backend or REAL_BACKENDS[device.type])
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
        rules = make_rules(cfg, mesh)
    model = build_model(cfg, tp=mesh_axes(mesh)["model"] if mesh else 1)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr, warmup_steps=2,
                                             total_steps=args.steps),
                       microbatches=args.microbatches,
                       dp_compress=args.dp_compress)
    step = build_train_step(model, tcfg)

    def step_fn(params, opt_state, batch):
        with sharding_context(mesh, rules):
            return step(params, opt_state, batch)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device {device.type} ({name})"
          + (f" mesh {args.mesh} on {dist.get_backend()}" if mesh else ""),
          flush=True)

    start_step = 0
    if args.resume and args.ckpt_dir and (ckpt.latest_step(args.ckpt_dir)
                                          is not None):
        last = ckpt.latest_step(args.ckpt_dir)
        target = {"params": model.spec, "opt": opt_state_spec(model)}
        shd = None if mesh is None else S.shardings(target, mesh, rules)
        restored, extra = ckpt.restore_checkpoint(args.ckpt_dir, last, target,
                                                  device, shd)
        params, opt_state = restored["params"], restored["opt"]
        start_step = extra.get("step", last)
        print(f"resumed from step {start_step}")
    else:
        params, opt_state = init_train_state(
            model, torch.Generator(device).manual_seed(0), device)
        if mesh is not None:
            params = S.place(params, model.spec, mesh, rules)
            opt_state = init_opt_state(params)

    ds = SyntheticTokenStream(cfg, shape, DataConfig(seed=0), mesh, device)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    wd = StepWatchdog(WatchdogConfig())
    losses = []
    for s in range(start_step, args.steps):
        batch = ds.batch(s)
        if args.microbatches > 1:
            batch = {k: x.reshape(args.microbatches, -1, *x.shape[1:])
                     for k, x in batch.items()}
        wd.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = _scalar(metrics["loss"])
        dt = wd.stop()
        losses.append(loss)
        print(f"step {s:4d} loss {loss:.4f} lr {_scalar(metrics['lr']):.2e} "
              f"gnorm {_scalar(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
              flush=True)
        if saver and (s + 1) % args.ckpt_every == 0:
            saver.save(s + 1, {"params": params, "opt": opt_state},
                       extra={"step": s + 1})
    if saver:
        saver.wait()
    return {"losses": losses, "straggler_events": wd.events}


if __name__ == "__main__":
    main()
