"""Atomic, async checkpoints (port of ``repro.ft.checkpoint``), in the
reference's on-disk layout, so a checkpoint written by either package
restores in the other:

    <dir>/step_000123.tmp-<nonce>/   (written)
        manifest.json                (step, extra, each leaf's dtype/shape)
        shard_0.npz                  (every leaf, keys joined by "__")
    <dir>/step_000123/               (atomic rename commit)

Leaves are keyed by their path of dict keys and list indices joined by
"/", dict keys in sorted order as JAX flattens them; bf16 leaves are stored
as their uint16 bit patterns. One process writes every leaf whole (the
reference's single-process layout). Restore re-shards: given target
shardings (or DTensor target leaves), each leaf is placed on its mesh
placement, so a checkpoint taken on one mesh restores onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.spec import tree_map
from repro_torch.sharding.rules import distribute

_SEP = "/"


def _flatten(tree: Any, prefix: tuple = ()) -> dict[str, Any]:
    """{path key: leaf}, in JAX's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten(t, prefix + (i,)))
        return out
    if tree is None:
        return {}
    return {_SEP.join(str(p) for p in prefix): tree}


def _whole(t: Any) -> Any:
    """A DTensor gathered whole (every rank writes full leaves)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array as stored, manifest dtype): bf16 as its uint16 bits; a
    DTensor whole."""
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Write atomically; returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest: dict[str, Any] = {"step": step, "extra": extra or {},
                                "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
        arrays[key.replace("/", "__")] = arr
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Any,
                       device: torch.device | str = "cuda",
                       shardings: Any | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``target`` (tensors or a TensorSpec
    tree) on ``device`` (the card unless the caller asks for the CPU).
    With ``shardings`` (a tree of ``NamedSharding`` like ``target``), or
    where a target leaf is a DTensor, each leaf is placed on its mesh
    placement instead: elastic restore onto any mesh. Returns (tree,
    extra)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shard_0.npz"))
    shd_by_key = _flatten(shardings) if shardings is not None else {}
    by_key = {}
    for key, leaf in _flatten(target).items():
        info = manifest["leaves"][key]
        raw = data[key.replace("/", "__")]
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(raw))
        assert tuple(t.shape) == tuple(leaf.shape), (key, t.shape, leaf.shape)
        shd = shd_by_key.get(key)
        if shd is None and isinstance(leaf, DTensor):
            by_key[key] = distribute_tensor(
                t.to(leaf.device_mesh.device_type), leaf.device_mesh,
                list(leaf.placements))
        elif shd is not None:
            by_key[key] = distribute(t.to(shd.mesh.device_type), shd)
        else:
            by_key[key] = t.to(device)
    return _unflatten_like(target, by_key), manifest["extra"]


def _unflatten_like(target: Any, by_key: dict[str, Any],
                    prefix: tuple = ()) -> Any:
    if isinstance(target, dict):
        return {k: _unflatten_like(v, by_key, prefix + (k,))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(t, by_key, prefix + (i,))
                            for i, t in enumerate(target))
    if target is None:
        return None
    return by_key[_SEP.join(str(p) for p in prefix)]


class AsyncCheckpointer:
    """Fire-and-forget background saves with a bounded queue of one: a new
    save waits for the previous one (so at most one tmp dir exists)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        # the copy to host on the caller thread (a consistent snapshot of
        # leaves the next step updates in place), IO off-thread
        host_tree = tree_map(lambda x: _whole(x).detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else np.asarray(x),
                             tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and ".tmp" not in d)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
