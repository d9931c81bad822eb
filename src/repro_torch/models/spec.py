"""Parameter/cache spec trees (port of ``repro.models.spec``).

A model is *described* first (nested dict/list of TensorSpec) and only then
materialized. The same spec tree drives real initialization and the byte
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


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                ) -> list:
    out: list = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def tree_map_spec(fn: Callable[[TensorSpec], Any], tree: SpecTree) -> Any:
    return tree_map(fn, tree, is_leaf=_is_spec)


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
    """numpy -> tensor, bit for bit. bfloat16 arrays (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) travel as their uint16 bit patterns."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def params_from_numpy(tree: Any, device: torch.device | str) -> ArrayTree:
    """Weights bridge: a parameter tree of numpy arrays (the reference's
    ``Model.init`` output, converted leaf by leaf) -> tensors, same keys."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def count_params(tree: SpecTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree, _is_spec))


def tree_bytes(tree: SpecTree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(tree, _is_spec))
