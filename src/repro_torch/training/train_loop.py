"""Train step (port of ``repro.training.train_loop``): microbatch
accumulation in fp32, remat and AdamW.

The reference differentiates ``Model.loss_fn`` with ``jax.value_and_grad``
and scans microbatches; here ``torch.autograd.grad`` takes the gradient of
the same loss with respect to every parameter leaf and a Python loop
accumulates. The optimizer updates in place (``optimizer``). On a mesh the
parameters are DTensors and the gradient reduction across data-parallel
ranks is DTensor's, pinned to each parameter's placement
(``constrain_grads_like_params``); ``dp_compress`` is carried and unused,
exactly as in the reference, whose step never calls
``compression.reduce_gradients`` either.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.models.model import Model
from repro_torch.models.spec import TensorSpec, tree_leaves, tree_map, \
    tree_map_spec
from repro_torch.sharding.rules import current_context, placements, resolve
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def constrain_grads_like_params(model: Model, grads: Any) -> Any:
    """Pin each gradient to its parameter's placement: a gradient still
    pending as a ``Partial`` sum over the data axes becomes the
    reduce-scatter onto the parameter's shards, not a full all-reduce.
    No-op outside a sharding context (single-device runs)."""
    mesh, rules = current_context()
    if not isinstance(mesh, DeviceMesh) or rules is None:
        return grads

    def pin(g, ts):
        if not isinstance(g, DTensor):
            return g
        want = placements(resolve(ts.shape, ts.logical, rules, mesh), mesh)
        return g if tuple(g.placements) == want else g.redistribute(
            g.device_mesh, want)

    return tree_map(pin, grads, model.spec)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the step: the embedding
    lookup's backward (an index_put with accumulation) and every other op
    that has a deterministic CUDA implementation take it, so a step's bits
    repeat (ROADMAP's determinism rule). ``warn_only``: an op without one
    warns rather than raises, and the card's bitwise check catches it. The
    NaN fill of fresh allocations, a debugging aid of that mode, stays off.
    The previous settings come back on exit."""
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1        # grad-accumulation steps per train_step
    remat: bool = True
    dp_compress: str = "none"    # none | bf16 | int8_ef (cross-pod explicit)


def build_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch leaves have a leading microbatch dim when
    tcfg.microbatches > 1."""

    def grad_fn(params, mb):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _m = model.loss_fn(live, mb, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        with deterministic():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(tcfg.microbatches):
                loss, g = grad_fn(params, {k: v[i] for k, v in batch.items()})
                # on a mesh, each microbatch's gradient meets the sum in
                # its parameter's placement (in place, no layout change)
                g = constrain_grads_like_params(model, g)
                for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                    a.add_(b.float())
                lsum = lsum + loss
            grads = tree_map(lambda g: g / tcfg.microbatches, gsum)
            loss = lsum / tcfg.microbatches
        else:
            loss, grads = grad_fn(params, batch)
        grads = constrain_grads_like_params(model, grads)
        params2, opt_state2, om = adamw_update(
            tcfg.optimizer, params, grads, opt_state)
        return params2, opt_state2, {"loss": loss, **om}

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     device: torch.device | str):
    params = model.init(generator, device)
    return params, init_opt_state(params)


def opt_state_spec(model: Model):
    """TensorSpec tree for the optimizer state (fp32 moments mirror params)."""
    f32 = lambda s: dataclasses.replace(s, dtype=torch.float32)
    return {
        "m": tree_map_spec(f32, model.spec),
        "v": tree_map_spec(f32, model.spec),
        "count": TensorSpec((), (), dtype=torch.int32, init="zeros"),
    }
