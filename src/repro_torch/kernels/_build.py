"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are
named by the hash of their source, so an edited kernel rebuilds and a
built one is reused. ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time.

Beside the build, what every kernel wrapper shares: a fake tensor (the dry
run's stand-in, ``launch.dryrun``) takes a kernel's path up to the launch
(its checks, its output allocation, its cost report) and launches nothing;
each launch, real or fake, reports its FLOPs and bytes to the listening
cost counters (``launch.hlo_costs``), which cannot see inside a kernel;
and ``on_local_shards`` runs a wrapper on each rank's shard of DTensor
arguments.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("decode_attention", "flash_attention", "prefill_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}

# the cost counters listening to kernel launches: each is called as
# sink(kernel name, FLOPs, bytes); a counter adds itself while it counts
COST_SINKS: list[Callable[[str, float, float], None]] = []
_trips = threading.local()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, float]:
    """Compile every kernel source in parallel; returns seconds per source
    (0.0 for a library already built from the same source)."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    secs = {}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
        secs[name] = time.perf_counter() - t0 if job is not None else 0.0
    return secs


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    if name not in _LIBS:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


def require_vector_aligned(name: str, t) -> None:
    """Raise unless 16-byte vector loads can read every row of tensor
    ``t``: its data pointer 16-byte aligned and every stride but the last
    (unit) one a whole number of 16-byte pieces."""
    ptr = 0 if is_fake(t) else t.data_ptr()
    if ptr % 16 or any(s * t.element_size() % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: the kernel's 16-byte loads need a 16-byte "
                         f"aligned base and strides in multiples of 16 "
                         f"bytes, got strides {t.stride()} at offset "
                         f"{ptr % 16} mod 16")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def is_fake(t: torch.Tensor) -> bool:
    """A fake tensor: shapes and no memory; its kernel call launches
    nothing."""
    return isinstance(t, FakeTensor)


def on_kernel_path(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its kernel's path for ``t``: a CUDA tensor,
    or a fake one. A real CPU tensor takes the plain version."""
    return t.is_cuda or is_fake(t)


@contextlib.contextmanager
def repeated(n: int):
    """Have the cost counters count everything run inside ``n`` times over
    (nested: the product): one traced trip of a loop standing for its
    ``n`` trips."""
    prev = trip_weight()
    _trips.n = prev * n
    try:
        yield
    finally:
        _trips.n = prev


def trip_weight() -> int:
    return getattr(_trips, "n", 1)


def report(name: str, flops: float, nbytes: float) -> None:
    """One kernel launch's FLOPs and bytes, to every listening counter."""
    for sink in COST_SINKS:
        sink(name, flops, nbytes)


def on_local_shards(fn: Callable, *args, align_heads: bool = False,
                    **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local shard of the DTensor
    arguments (``local_map``; differentiable), returning a DTensor. A
    kernel reads raw pointers, which a DTensor's are not, so no DTensor
    may reach one. With ``align_heads`` (attention over [B, heads, ...]
    inputs that are all DTensors) a mesh dim keeps a shard that every
    argument has on dim 0 (batch) or dim 1 (heads): Q's heads and the K/V
    heads split alike keep each query head's group on its rank. Every other
    mesh dim is replicated first, and with it each plain argument (block
    tables, a page pool) meets the whole of its batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dts = [a for a in args if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    keep_ok = align_heads and len(dts) == len(args)
    want = []
    for i in range(mesh.ndim):
        seen = {a.placements[i] for a in dts}
        p = seen.pop() if len(seen) == 1 else None
        want.append(p if keep_ok and p in (Shard(0), Shard(1))
                    else Replicate())
    want = tuple(want)
    in_pl = tuple(want if isinstance(a, DTensor) else None for a in args)
    return local_map(lambda *a: fn(*a, **kwargs), out_placements=(want,),
                     in_placements=in_pl, redistribute_inputs=True,
                     device_mesh=mesh)(*args)
