"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are
named by the hash of their source, so an edited kernel rebuilds and a
built one is reused. ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("decode_attention", "flash_attention", "prefill_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


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
    if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                for s in t.stride()[:-1]):
        raise ValueError(f"{name}: the kernel's 16-byte loads need a 16-byte "
                         f"aligned base and strides in multiples of 16 "
                         f"bytes, got strides {t.stride()} at offset "
                         f"{t.data_ptr() % 16} mod 16")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
