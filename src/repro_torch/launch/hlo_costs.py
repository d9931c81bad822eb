"""The traced step's costs (port of ``repro.launch.hlo_costs``).

The reference re-derives three roofline inputs from XLA's compiled HLO
text, because ``cost_analysis`` counts a ``lax.scan`` body once and charges
whole buffers to slice fusions. PyTorch emits no HLO, so the port counts
the step as it runs, op by op, under a ``TorchDispatchMode``
(``CostCounter``); a step traced on fake tensors (``launch.dryrun``) is
counted the same way, at no memory.

* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) for each op, plus each hand-written kernel's own
  report (``kernels._build.report``, chip_smoke's bound formulas), which
  dispatch cannot see into;
* ``hbm_bytes``: each op's operand and result bytes. A view counts its own
  elements, never its base's, so a one-token cache update through a slice
  counts the slice, and an op that reads the whole cache counts it whole.
  An in-place update through indices or a copy into a view counts its
  update twice (read, write) and its indices, as the reference counts a
  dynamic-update-slice. Ops that only alias (views) or allocate count 0;
* ``hbm_bytes_native``: the same less copies and dtype conversions
  (``clone``, ``_to_copy``, ``copy``), the data movement a fusing compiler
  keeps out of memory, as the reference leaves out its copy and convert
  fusions;
* ``collective_bytes``: per-device wire bytes where a collective is issued
  (DTensor's redistributions and the functional collectives), under the
  reference's ring models: all-gather (g-1)/g of the result, all-reduce
  2(g-1)/g, reduce-scatter (g-1) times the result, all-to-all (g-1)/g,
  anything else its result once.

The reference weights loop bodies by trip counts; the port's layer stacks
are Python loops, so every layer is counted as it runs. The long scans
inside a layer (Mamba's chunks, the xLSTM steps) run every trip on real
tensors; on fake tensors one trip stands for all of them, counted
``kernels._build.repeated(trips)`` times, as the reference weights its
scan bodies. Everything is per device: under a DTensor the counter sees each
rank's local ops (an op on DTensors is passed on to DTensor, whose local
ops and collectives come back through the counter), never the global one.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import Counter

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

aten = torch.ops.aten

# an update of part of its first argument: counted as the update read and
# written, plus its indices
_UPDATES = {aten.copy_, aten.index_put_, aten.index_put, aten.index_copy_,
            aten.index_copy, aten.index_add_, aten.index_add, aten.scatter_,
            aten.scatter, aten.scatter_add_, aten.scatter_add,
            aten.masked_scatter_, aten.slice_scatter, aten.select_scatter}
# data movement a fusing compiler keeps out of memory (``hbm_bytes_native``
# leaves it out)
_ARTIFACTS = {aten.clone, aten._to_copy, aten.copy}
# allocations and metadata: no traffic
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten._local_scalar_dense,
               aten.sym_size, aten.sym_stride, aten.sym_numel,
               aten.sym_storage_offset}

_RING = {"all_reduce": ("all-reduce", lambda rb, g: 2 * rb * (g - 1) / g),
         "all_gather_into_tensor": ("all-gather",
                                    lambda rb, g: rb * (g - 1) / g),
         "reduce_scatter_tensor": ("reduce-scatter",
                                   lambda rb, g: rb * (g - 1)),
         "all_to_all_single": ("all-to-all", lambda rb, g: rb * (g - 1) / g)}


@dataclasses.dataclass
class HloCosts:
    flops: float
    hbm_bytes: float          # every op's traffic, copies and casts in
    hbm_bytes_native: float   # less copies and dtype conversions
    collective_bytes: dict[str, float]
    collective_count: dict[str, int]
    kernel_flops: float = 0.0     # the hand-written kernels' share
    kernel_bytes: float = 0.0
    kernel_calls: dict[str, int] = dataclasses.field(default_factory=dict)
    trip_weighted: bool = True    # every layer counted as it ran

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_sharding_propagation() -> bool:
    """Whether DTensor is running an op on fake stand-ins of its global
    shapes to learn the output's metadata: not the step's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _group_size(args, default: int) -> int:
    """The size of the group a functional collective names (its last str
    argument)."""
    import torch.distributed.distributed_c10d as c10d

    names = [a for a in args if isinstance(a, str)]
    if names:
        try:
            return c10d._resolve_process_group(names[-1]).size()
        except (ValueError, RuntimeError, KeyError):
            pass
    return default


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of everything run inside it
    (see the module note); ``costs()`` reads them. ``default_group`` is the
    group size of a collective whose group cannot be read."""

    def __init__(self, default_group: int = 2):
        super().__init__()
        self.default_group = default_group
        self.flops = 0.0
        self.hbm = 0.0
        self.hbm_native = 0.0
        self.coll: Counter = Counter()
        self.ccount: Counter = Counter()
        self.kflops = 0.0
        self.kbytes = 0.0
        self.kcalls: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.live = 0          # bytes of op outputs not yet collected
        self.peak_live = 0

    def __enter__(self):
        _build.COST_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COST_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        w = _build.trip_weight()
        flops, nbytes = flops * w, nbytes * w
        self.kflops += flops
        self.kbytes += nbytes
        self.kcalls[name] += w
        self.flops += flops
        self.hbm += nbytes
        self.hbm_native += nbytes
        self.flops_by_op[name] += flops
        self.bytes_by_op[name] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in tensors):
            return NotImplemented      # DTensor runs it; its local ops return
        out = func(*args, **kwargs)
        if (not tensors or any(_build.is_fake(t) for t in tensors)) \
                and _in_sharding_propagation():
            return out
        self._count(func, args, kwargs, tensors, out)
        self._track(func, out)
        return out

    def _track(self, func, out) -> None:
        """The live-set tracker: an op's fresh outputs count from now until
        they are collected (views and in-place results hold no new
        memory)."""
        if func.is_view or any(r.alias_info is not None
                               for r in func._schema.returns):
            return
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel():
                n = _nbytes(t)
                self.live += n
                self.peak_live = max(self.peak_live, self.live)
                weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _count(self, func, args, kwargs, tensors, out) -> None:
        packet = func._overloadpacket
        name = str(packet)
        w = _build.trip_weight()
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "c10d"):
            op = name.split(".")[-1].rstrip("_")
            if op in ("wait_tensor", "barrier") or op.startswith("_"):
                return          # completion, and autograd wrappers
            kind, moved = _RING.get(op, ("collective-permute",
                                         lambda rb, g: rb))
            g = max(_group_size(args, self.default_group), 2)
            rb = sum(_nbytes(t) for t in outs) or sum(_nbytes(t)
                                                      for t in tensors)
            self.coll[kind] += moved(rb, g) * w
            self.ccount[kind] += w
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out)) * w
            self.flops += f
            self.flops_by_op[name] += f
        if packet in _NO_TRAFFIC or func.is_view or not func.namespace \
                == "aten":
            return
        if packet in _UPDATES:
            is_idx = [t.dtype in (torch.int64, torch.bool)
                      for t in tensors[1:]]
            b = sum(_nbytes(t) * (1 if i else 2)
                    for t, i in zip(tensors[1:], is_idx))
        else:
            b = sum(_nbytes(t) for t in tensors) + sum(_nbytes(t)
                                                       for t in outs)
        b *= w
        self.hbm += b
        if packet not in _ARTIFACTS:
            self.hbm_native += b
        self.bytes_by_op[name] += b

    def costs(self) -> HloCosts:
        return HloCosts(flops=self.flops, hbm_bytes=self.hbm,
                        hbm_bytes_native=self.hbm_native,
                        collective_bytes=dict(self.coll),
                        collective_count=dict(self.ccount),
                        kernel_flops=self.kflops, kernel_bytes=self.kbytes,
                        kernel_calls=dict(self.kcalls))


def count(fn, *args, default_group: int = 2, **kwargs):
    """(fn(*args, **kwargs), its HloCosts)."""
    with CostCounter(default_group) as c:
        out = fn(*args, **kwargs)
    return out, c.costs()
