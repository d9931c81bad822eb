"""End-to-end training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ck

The reference's flags and output lines, plus ``--device`` (cuda unless the
caller asks for the CPU): the seeded token stream, remat, AdamW, async
checkpoints, the watchdog and ``--resume``. One device: a ``--mesh`` other
than 1x1 is ROADMAP Queue A item 11.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.reduced import reduce_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.watchdog import StepWatchdog, WatchdogConfig
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (TrainConfig, build_train_step,
                                             init_train_state, opt_state_spec)


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
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port trains on one device; "
                 f"meshes are ROADMAP Queue A item 11")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device (pass --device cpu)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    model = build_model(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr, warmup_steps=2,
                                             total_steps=args.steps),
                       microbatches=args.microbatches,
                       dp_compress=args.dp_compress)
    step_fn = build_train_step(model, tcfg)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device {device.type} ({name})", flush=True)

    start_step = 0
    if args.resume and args.ckpt_dir and (ckpt.latest_step(args.ckpt_dir)
                                          is not None):
        last = ckpt.latest_step(args.ckpt_dir)
        target = {"params": model.spec, "opt": opt_state_spec(model)}
        restored, extra = ckpt.restore_checkpoint(args.ckpt_dir, last, target,
                                                  device)
        params, opt_state = restored["params"], restored["opt"]
        start_step = extra.get("step", last)
        print(f"resumed from step {start_step}")
    else:
        params, opt_state = init_train_state(
            model, torch.Generator(device).manual_seed(0), device)

    ds = SyntheticTokenStream(cfg, shape, DataConfig(seed=0), None, device)
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
        loss = float(metrics["loss"])
        dt = wd.stop()
        losses.append(loss)
        print(f"step {s:4d} loss {loss:.4f} lr {float(metrics['lr']):.2e} "
              f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
              flush=True)
        if saver and (s + 1) % args.ckpt_every == 0:
            saver.save(s + 1, {"params": params, "opt": opt_state},
                       extra={"step": s + 1})
    if saver:
        saver.wait()
    return {"losses": losses, "straggler_events": wd.events}


if __name__ == "__main__":
    main()
