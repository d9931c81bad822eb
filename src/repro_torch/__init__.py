"""PyTorch/CUDA port of the Select-N serving system.

Mirrors ``repro`` module for module. Imports torch and numpy, never JAX.
cuBLAS is pinned to a deterministic workspace before any handle exists, so
GEMM bits depend only on shapes (the bucketed-prefill bitwise contract).
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
