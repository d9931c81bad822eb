"""Logical-axis sharding rules (port of ``repro.sharding.rules``).

Tensors are annotated with *logical* axis names ("batch", "heads", "mlp", ...).
``resolve()`` maps them onto mesh axes with two safety properties that make
every (arch × shape × mesh) cell trace:

1. divisibility fallback — a candidate mesh-axis tuple is only used if the dim
   size divides evenly; otherwise the next candidate (or replication) is used;
2. no-double-use — a mesh axis is consumed at most once per spec, resolved
   greedily left-to-right. This is what makes e.g. the KV cache
   ``[batch, cache_seq, kv, head_dim]`` shard batch over "data" for decode_32k
   (batch=128) but *sequence* over "data" for long_500k (batch=1): batch=1
   fails divisibility, leaving "data" free for cache_seq.

The rules are derived from (ModelConfig, mesh): giant (param_fsdp) archs add
the data axes as a candidate for parameter "fsdp" dims; MoE expert dims try
the model axis (EP) and otherwise leave TP to the per-expert FFN dims.

A resolved spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dim a tuple of mesh axis names or None, trailing Nones trimmed.
``placements`` turns it into DTensor placements over a
``torch.distributed.DeviceMesh``. The rules read only a mesh's axis names
and sizes, so they also take a ``MeshShape``, a mesh without devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig

Rules = dict[str, list[tuple[str, ...]]]
Spec = tuple[tuple[str, ...] | None, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names without devices: enough for the rules
    (``make_rules``, ``resolve``), not for placing a tensor."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_axes(mesh: DeviceMesh | MeshShape) -> dict[str, int]:
    """{axis name: size} in mesh order, of a DeviceMesh or a MeshShape."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a DeviceMesh with mesh_dim_names")
    return dict(zip(names, mesh.shape))


def virtual_kv_heads(cfg: ModelConfig, tp: int) -> int:
    """Number of *stored* KV heads after replication for tensor parallelism.

    Smallest v with v % kv == 0, v % tp == 0, heads % v == 0 (the standard
    vLLM/MaxText KV replication scheme). Falls back to kv (no expansion) when
    impossible — then attention is not head-sharded on this mesh.
    """
    kv, h = cfg.num_kv_heads, cfg.num_heads
    for mult in range(1, h // kv + 1):
        v = kv * mult
        if v % tp == 0 and h % v == 0:
            return v
    return kv


def make_rules(cfg: ModelConfig, mesh: DeviceMesh | MeshShape,
               step: str = "train", global_batch: int | None = None) -> Rules:
    """The reference's rules, read from the mesh's axis names and sizes
    (the comments on each choice are the reference's)."""
    shape = mesh_axes(mesh)
    has_pod = "pod" in shape
    dp: tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    tp = shape["model"]

    fsdp_cands: list[tuple[str, ...]] = [dp, ("data",)] if cfg.param_fsdp else []
    expert_mlp_cands: list[tuple[str, ...]] = [("model",)]

    # Weight-stationary decode pays when the batch amortizes the replicated
    # weight reads; at tiny batches (long_500k: batch 1) the per-chip
    # weight READ dominates. Threshold: one decode row per data shard.
    ws_decode = step == "decode" and (
        global_batch is None or global_batch >= shape.get("data", 1))

    if ws_decode:
        # Weight-stationary decode layout: drop the fsdp dim and shard the
        # expert hidden dim over BOTH mesh axes; dense MLP / mamba inner
        # dims keep the 1D "model" rule.
        fsdp_cands = []
        expert_mlp_cands = [dp + ("model",) if has_pod
                            else ("data", "model"),
                            dp, ("data",), ("model",)]

    # MoE dispatch activations: batch-sharded during train/prefill, but
    # REPLICATED at decode (the dispatched tokens are a few MB).
    moe_batch: list[tuple[str, ...]] = [] if ws_decode \
        else [dp, ("data",)]

    # Sub-scale-TP remap: when the replicated train state (~18 B/param) of
    # the non-embedding stack fits comfortably on one chip, fold the model
    # axis into data parallelism and replicate the stack; embeddings stay
    # vocab-sharded on the model axis.
    d = cfg.d_model
    embed_params = cfg.padded_vocab() * d * (1 if cfg.tie_embeddings else 2)
    stack_params = max(cfg.num_params() - embed_params, 0)
    # Recurrent mixers (sLSTM/mLSTM) are excluded: their per-token scans
    # reduce recurrent-weight grads across the batch axes inside the loop.
    attention_only = all(b.mixer == "attention" for b in cfg.pattern)
    small_dp = (step == "train" and attention_only
                and stack_params * 18 < 10e9)
    batch_cands: list[tuple[str, ...]] = [dp, ("data",)]
    if small_dp:
        batch_cands = [dp + ("model",) if has_pod else ("data", "model"),
                       dp, ("data",)]

    rules: Rules = {
        # activations -------------------------------------------------------
        "batch": batch_cands,
        "moe_batch": moe_batch,
        "seq": [],                      # sharded only via explicit SP paths
        "embed": [],                    # activation d_model dim
        "heads": [] if small_dp else [("model",)],
        "kv": [] if small_dp else [("model",)],   # virtual kv (post expand)
        "head_dim": [],
        "mlp": [] if small_dp else [("model",)],
        "expert_mlp": [] if small_dp else expert_mlp_cands,
        "experts": [] if small_dp else [("model",)],
        "capacity": [],
        # caches -------------------------------------------------------------
        "cache_seq": [dp, ("data",)],   # only wins when batch couldn't shard
        "state": [] if small_dp else [("model",)],  # SSM/recurrent inner dim
        # params --------------------------------------------------------------
        "fsdp": fsdp_cands,             # param in-dims for giant archs
        "vocab": [("model",)],
        "stack": [],                    # stacked layer dim: never sharded
        "conv": [],
        None: [],
    }
    return rules


def resolve(shape: Sequence[int], logical: Sequence[str | None], rules: Rules,
            mesh: DeviceMesh | MeshShape) -> Spec:
    """Map logical axis names to a spec honouring divisibility and
    single-use of mesh axes (greedy, left-to-right)."""
    assert len(shape) == len(logical), (shape, logical)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out: list[tuple[str, ...] | None] = []
    for dim, name in zip(shape, logical):
        placed: tuple[str, ...] | None = None
        for cand in rules.get(name, []):
            if any(a in used for a in cand):
                continue
            size = math.prod(sizes[a] for a in cand)
            if size > 1 and dim % size == 0:
                placed = cand
                used.update(cand)
                break
        out.append(placed)
    # trim trailing Nones for tidiness
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Spec, mesh: DeviceMesh | MeshShape
               ) -> tuple[Placement, ...]:
    """DTensor placements of a resolved spec: ``Shard(d)`` on each mesh dim
    the spec assigns to tensor dim d, ``Replicate()`` on every other.

    A tensor dim over several mesh axes is split major to minor in the
    tuple's order, as ``PartitionSpec(("data", "model"))`` splits it; a
    DTensor's repeated ``Shard(d)`` splits in mesh-dim order, so the tuple
    must list its axes in mesh order (every rule does)."""
    names = list(mesh_axes(mesh))
    out: list[Placement] = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Context: model code calls shard(x, "batch", "seq", ...) without threading
# mesh/rules through every function signature.
# ---------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def sharding_context(mesh: DeviceMesh | MeshShape | None,
                     rules: Rules | None):
    """Set the (mesh, rules) that ``shard`` and the gradient constraint
    read. On a DeviceMesh, plain tensors the step makes (positions, masks,
    scalars) combine with DTensors as replicated values."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = (mesh, rules)
    try:
        if isinstance(mesh, DeviceMesh):
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ctx.val = prev


def current_context() -> tuple[DeviceMesh | MeshShape | None, Rules | None]:
    val = getattr(_ctx, "val", None)
    return val if val is not None else (None, None)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``want`` forward, and the gradient to ``want`` in
    the backward too: a sharding constraint's transpose is the same
    constraint, as JAX differentiates ``with_sharding_constraint``."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor is redistributed to the resolved placements inside a context on
    a DeviceMesh, and so is its gradient; outside one (or in one on a
    MeshShape), and for a plain tensor, it is a no-op."""
    mesh, rules = current_context()
    if not isinstance(mesh, DeviceMesh) or rules is None \
            or not isinstance(x, DTensor):
        return x
    want = placements(resolve(x.shape, logical, rules, mesh), mesh)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, want)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives on a mesh: its resolved spec, the placements
    that spec gives, and the memory kind. ``memory_kind="pinned_host"``
    is the pinned-CPU placement the engine gives offloaded weight units
    (one copy in pinned host memory, streamed to the device per use)."""
    mesh: Any
    spec: Spec
    memory_kind: str | None = None

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.spec, self.mesh)


def named_sharding(mesh: DeviceMesh | MeshShape, rules: Rules,
                   shape: Sequence[int], logical: Sequence[str | None],
                   memory_kind: str | None = None) -> NamedSharding:
    return NamedSharding(mesh, resolve(shape, logical, rules, mesh),
                         memory_kind)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """Place a full tensor where ``sharding`` says: a DTensor over the
    mesh (each rank keeps its shard), or, for ``pinned_host``, a pinned
    host copy."""
    if sharding.memory_kind == "pinned_host":
        return t.detach().to("cpu").contiguous().pin_memory()
    if not isinstance(sharding.mesh, DeviceMesh):
        raise ValueError("placing a tensor needs a DeviceMesh, not a "
                         "MeshShape")
    return distribute_tensor(t.detach(), sharding.mesh,
                             list(sharding.placements))
