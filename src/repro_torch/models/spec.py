"""Parameter/cache spec trees (port of ``repro.models.spec``).

A model is *described* first (nested dict/list of TensorSpec) and only then
materialized. The same spec tree drives real initialization, fake-tensor
stand-ins (the dry run), mesh placements (logical axes -> mesh axes via the
sharding rules, with pinned_host for offloaded layer stacks) and the byte
accounting in ``core.costs``. ``params_from_numpy`` is the weights bridge:
it turns a reference parameter tree given as numpy arrays into tensors under
the same keys, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.sharding.rules import (NamedSharding, Rules, distribute,
                                        named_sharding)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    fan_in_axes: tuple[int, ...] = (0,)  # axes treated as fan-in for scaling

    def stacked(self, n: int) -> "TensorSpec":
        return dataclasses.replace(
            self, shape=(n, *self.shape), logical=("stack", *self.logical),
            fan_in_axes=tuple(a + 1 for a in self.fan_in_axes),
        )


SpecTree = Any  # nested dict/list of TensorSpec
ArrayTree = Any


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """Map over dict/list/tuple containers (None is an empty subtree)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, is_leaf: Callable[[Any], bool]
                      | None = None, path: tuple = ()) -> Any:
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's path of
    dict keys and list indices."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, is_leaf, path + (i,))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                ) -> list:
    out: list = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def tree_map_spec(fn: Callable[[TensorSpec], Any], tree: SpecTree) -> Any:
    return tree_map(fn, tree, is_leaf=_is_spec)


def abstract(tree: SpecTree, fake_mode: FakeTensorMode,
             device: torch.device | str = "cpu") -> ArrayTree:
    """Fake tensors of each spec's shape and dtype (no memory), made in
    ``fake_mode``: the dry run's stand-ins for parameters and caches."""
    with fake_mode:
        return tree_map_spec(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                   device=device), tree)


def shardings(tree: SpecTree, mesh: Any, rules: Rules,
              memory_kind_fn: Callable[[tuple], str | None] | None = None
              ) -> Any:
    """NamedSharding tree. memory_kind_fn(path) -> kind lets the offload
    plan mark specific subtrees pinned_host."""
    return tree_map_with_path(
        lambda path, s: named_sharding(
            mesh, rules, s.shape, s.logical,
            memory_kind_fn(path) if memory_kind_fn else None),
        tree, _is_spec)


def fake_dtensor(shape: tuple[int, ...], dtype: torch.dtype,
                 sharding: NamedSharding, fake_mode: FakeTensorMode,
                 device: torch.device | str = "cpu") -> DTensor:
    """A DTensor of global ``shape`` placed by ``sharding`` whose local
    shard (this rank's) is a fake tensor."""
    mesh, pl = sharding.mesh, list(sharding.placements)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    with fake_mode:
        t = torch.empty(local, dtype=dtype, device=device)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def abstract_with_sharding(tree: SpecTree, mesh: Any, rules: Rules,
                           fake_mode: FakeTensorMode,
                           memory_kind_fn=None,
                           device: torch.device | str = "cpu") -> ArrayTree:
    """Fake DTensors with the placements the rules give each spec."""
    shd = shardings(tree, mesh, rules, memory_kind_fn)
    return tree_map(lambda s, n: fake_dtensor(s.shape, s.dtype, n, fake_mode,
                                              device),
                    tree, shd, is_leaf=_is_spec)


def place(values: ArrayTree, tree: SpecTree, mesh: Any, rules: Rules,
          memory_kind_fn=None) -> ArrayTree:
    """Put a tree of full tensors where the rules place each spec on a
    DeviceMesh: DTensors (or pinned host copies, by ``memory_kind_fn``)."""
    shd = shardings(tree, mesh, rules, memory_kind_fn)
    return tree_map(distribute, values, shd)


def initialize(tree: SpecTree, generator: torch.Generator,
               device: torch.device | str) -> ArrayTree:
    """Materialize a spec tree: zeros/ones, else N(0, 1/fan_in) drawn in
    float32 from ``generator`` and cast (the reference's fan-in scaling)."""
    def one(spec: TensorSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = max(math.prod(spec.shape[a] for a in spec.fan_in_axes), 1)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * (1.0 / math.sqrt(fan_in))).to(spec.dtype)

    return tree_map_spec(one, tree)


def to_tensor(arr: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """numpy -> tensor, bit for bit and shape for shape (a 0-d array stays
    0-d). bfloat16 arrays (``ml_dtypes``, which ``torch.from_numpy``
    refuses) travel as their uint16 bit patterns."""
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device: torch.device | str) -> ArrayTree:
    """Weights bridge: a parameter tree of numpy arrays (the reference's
    ``Model.init`` output, converted leaf by leaf) -> tensors, same keys.
    An optimizer state crosses the same way: fp32 moments ``m`` / ``v`` and
    the 0-d int32 step ``count``."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def count_params(tree: SpecTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree, _is_spec))


def tree_bytes(tree: SpecTree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(tree, _is_spec))
