"""Double-buffered async copy-stage engine for the tiered KV data plane
(port of ``repro.serving.data_plane``).

The allocator's ``disk_copy``/``park_copy``/``promote_copy``/``direct_copy``
hooks stage copy *ops* — (tier, src frame) -> (tier, dst frame) in planning
order — and the plane either executes each op at once (sync mode) or queues
them and drains at the next iteration boundary (async mode), batching
contiguous same-kind runs into one gather/scatter each and pushing
host->disk retirements to a background worker thread that overlaps decode.
The modeled clock (``iter_time_with_interval_kv``) assumes iteration i+1's
traffic overlaps iteration i's compute; this is what lets that hold for the
NVMe leg.

Hazard rules (the planning-order guarantees the token-exactness gates pin):

* The queue is FIFO and a drain executes ops in queue order — a linear
  extension of every WAW/RAW hazard the allocator's planning pass created.
  Transit-frame reuse is the canonical case: a host frame freed by a
  demotion and reallocated by a later park in the same pass is written
  only after the demotion has read it.
* A batched run flushes early when two ops in the run write the same dst
  frame: an indexed write with duplicate indices lands in no defined
  order, so duplicate dst writes never share a batch.
* Host->disk retirements run on the background worker. A drain waits for
  in-flight background jobs before executing any op that touches a frame
  a background job still reads or writes, and the engine guards its own
  host-pool writes (``guard_host_writes``) the same way. A retirement that
  a later op of the same drain touches runs inline instead, in queue
  order: that op would wait for the worker at once.
* Every drain starts by waiting out the previous iteration's background
  jobs: a staging issued in iteration i is complete — and counted in the
  completion totals — by the boundary of i+1.

Copies that touch the device pool (d2h, h2d, disk2d, d2disk) run inline
and blocking through ``kernels.ops``, in sync and async mode alike; only
the host->disk leg overlaps. The worker thread touches CPU tensors only
(the host pool, pinned on a GPU, and the disk pool) and makes no CUDA call.
It copies each page's bits with one ``numpy.copyto`` between views of the
two pools: a single-threaded memcpy that releases the interpreter lock, with
no temporary and no call into torch's intra-op thread pool, so it does not
contend with the serving thread for either.

The issued/completed page counters feed the telemetry plane (per-iteration
``staged_issued_pages``/``staged_completed_pages`` and the footer
conservation check I10): every staged page is charged exactly once, and at
any trace prefix completions never exceed issues.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops

# op kinds: device<->host, host<->disk, and the direct device<->disk path
# that bypasses the host bounce buffer (GPUDirect-style).
KINDS = ("d2h", "h2d", "h2disk", "disk2h", "disk2d", "d2disk")


def _ids(frames: Sequence[int]) -> torch.Tensor:
    return torch.as_tensor(frames, dtype=torch.long)


class CopyStageEngine:
    """Stages, batches and (optionally) overlaps physical page copies.

    ``host_pool``/``disk_pool`` are the engine's CPU tensors (stable
    identity, written in place). The device pool is reached through
    ``get_pool``/``set_pool``, as in the reference, although the port's
    copies update it in place too.
    """

    def __init__(self, *, host_pool: torch.Tensor, disk_pool: torch.Tensor,
                 get_pool: Callable, set_pool: Callable,
                 async_mode: bool = False, background: bool = True):
        self.host_pool = host_pool
        self.disk_pool = disk_pool
        # the pools' bits as numpy arrays sharing their memory (the worker's
        # copy routine, ``_host_to_disk``)
        self._host_bits = host_pool.view(torch.int16).numpy()
        self._disk_bits = disk_pool.view(torch.int16).numpy()
        self._get_pool = get_pool
        self._set_pool = set_pool
        self.async_mode = async_mode
        self._background = background and async_mode

        self._queue: list[tuple[str, int, int]] = []
        self._cv = threading.Condition()
        self.issued_pages_total = 0
        self.completed_pages_total = 0
        self._iter_issued = 0
        self._iter_completed = 0
        # wall seconds the physical copies cost the iteration thread (sync
        # stage() execs, drains, hazard waits) vs. seconds absorbed by the
        # background worker. A device->host copy synchronizes the device,
        # so blocking_copy_s also holds the wait for kernels queued before it
        self.blocking_copy_s = 0.0
        self.background_copy_s = 0.0

        # background h2disk worker state (guarded by self._cv)
        self._bg_pending = 0          # jobs submitted, not yet finished
        self._bg_host: set[int] = set()   # host frames in-flight jobs read
        self._bg_disk: set[int] = set()   # disk frames in-flight jobs write
        self._jobs: list[tuple[list[int], list[int]]] = []
        self._worker: threading.Thread | None = None
        if self._background:
            # started with the plane, so no drain on the serving thread
            # pays for the thread's start
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="kv-copy-stage")
            self._worker.start()

    # ----- staging ---------------------------------------------------------

    def stage(self, kind: str, src: int, dst: int) -> None:
        """Stage one page copy. Sync mode executes it immediately (planning
        order == execution order, per page); async mode queues it for the
        next drain."""
        assert kind in KINDS, kind
        with self._cv:
            self.issued_pages_total += 1
            self._iter_issued += 1
        if not self.async_mode:
            t0 = time.perf_counter()
            self._exec_group(kind, [src], [dst])
            self.blocking_copy_s += time.perf_counter() - t0
            with self._cv:
                self.completed_pages_total += 1
                self._iter_completed += 1
            return
        self._queue.append((kind, src, dst))

    # ----- draining --------------------------------------------------------

    def drain(self) -> None:
        """Iteration boundary: complete last iteration's background jobs,
        then execute every queued op in FIFO order, batching maximal
        consecutive same-kind runs (flushing on duplicate dst frames).
        Host->disk runs go to the background worker and overlap the rest of
        the iteration; everything else executes inline."""
        if not self.async_mode:
            return
        with self._cv:
            if not self._queue and not self._bg_pending:
                # nothing queued, nothing in flight: no copy to time
                self._bg_host.clear()
                self._bg_disk.clear()
                return
        t0 = time.perf_counter()
        try:
            self._drain_locked()
        finally:
            self.blocking_copy_s += time.perf_counter() - t0

    def _drain_locked(self) -> None:
        self._wait_bg()
        q, self._queue = self._queue, []
        i = 0
        while i < len(q):
            kind = q[i][0]
            srcs, dsts = [q[i][1]], [q[i][2]]
            seen = {q[i][2]}
            i += 1
            while i < len(q) and q[i][0] == kind and q[i][2] not in seen:
                srcs.append(q[i][1])
                dsts.append(q[i][2])
                seen.add(q[i][2])
                i += 1
            # a retirement that a later op of this same drain touches would
            # be waited for at once: it runs inline, sparing the handoff
            if kind == "h2disk" and self._background and not any(
                    self._conflicts(k, [src], [dst], set(srcs), set(dsts))
                    for k, src, dst in q[i:]):
                self._submit_bg(srcs, dsts)
            else:
                self._guard_group(kind, srcs, dsts)
                self._exec_group(kind, srcs, dsts)
                with self._cv:
                    self.completed_pages_total += len(srcs)
                    self._iter_completed += len(srcs)

    def sync(self) -> None:
        """Complete every queued and in-flight op (run end, trace export,
        or any external read of the physical pools)."""
        if not self.async_mode:
            return
        self.drain()
        t0 = time.perf_counter()
        self._wait_bg()
        self.blocking_copy_s += time.perf_counter() - t0

    # ----- peer handoff ----------------------------------------------------

    def peer_export(self, srcs: list[int], out: torch.Tensor) -> None:
        """Gather host frames into a handoff ticket payload (PEER tier
        export). The gather is a host-pool read, so every queued op that
        writes these frames — the park's d2h legs staged in the same
        planning pass — must land first: an async queue is drained before
        the copy. In-flight background retirements only *read* host
        frames, so they need no wait. The bytes are charged to the peer
        link's own latency term via the allocator's pending peer counters,
        never to the staged-plane totals."""
        if self.async_mode:
            self.drain()
        t0 = time.perf_counter()
        if srcs:
            out[:len(srcs)] = self.host_pool.index_select(0, _ids(srcs))
        self.blocking_copy_s += time.perf_counter() - t0

    def peer_import(self, payload: torch.Tensor, dsts: list[int]) -> None:
        """Scatter a handoff ticket payload into freshly claimed (distinct)
        host frames (PEER tier import). A host-pool write: any in-flight
        background retirement still reading these frames must finish
        first — the same guard every engine-side host write takes."""
        self.guard_host_writes(dsts)
        t0 = time.perf_counter()
        if dsts:
            self.host_pool.index_copy_(
                0, _ids(dsts), payload[:len(dsts)].to(self.host_pool.dtype))
        self.blocking_copy_s += time.perf_counter() - t0

    # ----- hazard guards ---------------------------------------------------

    def guard_host_writes(self, frames) -> None:
        """Engine-side host-pool writes (prefill spill scatter, streamed
        writeback, COW landing) must not overwrite a frame an in-flight
        background retirement is still reading."""
        if not self._background:
            return
        with self._cv:
            if self._bg_pending == 0:
                self._bg_host.clear()
                self._bg_disk.clear()
                return
            conflict = any(f in self._bg_host for f in frames)
        if conflict:
            t0 = time.perf_counter()
            self._wait_bg()
            self.blocking_copy_s += time.perf_counter() - t0

    def _guard_group(self, kind: str, srcs: list[int],
                     dsts: list[int]) -> None:
        """Before an inline group runs, wait out background jobs whose
        frames it conflicts with. Background jobs read host frames and
        write disk frames; read-read sharing is safe."""
        if not self._background:
            return
        with self._cv:
            if self._bg_pending == 0:
                self._bg_host.clear()
                self._bg_disk.clear()
                return
            conflict = self._conflicts(kind, srcs, dsts, self._bg_host,
                                       self._bg_disk)
        if conflict:
            self._wait_bg()

    @staticmethod
    def _conflicts(kind: str, srcs: list[int], dsts: list[int],
                   bg_host: set[int], bg_disk: set[int]) -> bool:
        """Does a group of ``kind`` touch the frames of background jobs
        that read host frames ``bg_host`` and write disk frames
        ``bg_disk``? Read-read sharing is safe."""
        if kind in ("d2h", "disk2h") and any(f in bg_host for f in dsts):
            return True                         # writes host dsts
        if kind in ("disk2h", "disk2d") and any(f in bg_disk for f in srcs):
            return True                         # reads disk srcs
        return kind in ("h2disk", "d2disk") and any(f in bg_disk
                                                    for f in dsts)

    # ----- background worker -----------------------------------------------

    def _submit_bg(self, srcs: list[int], dsts: list[int]) -> None:
        with self._cv:
            # WAW on a reclaimed disk frame (or RAR on a reused host frame)
            # against an earlier in-flight job: drain it first.
            conflict = (self._bg_pending > 0
                        and (any(d in self._bg_disk for d in dsts)
                             or any(s in self._bg_host for s in srcs)))
        if conflict:
            self._wait_bg()
        with self._cv:
            self._bg_pending += 1
            self._bg_host.update(srcs)
            self._bg_disk.update(dsts)
            self._jobs.append((srcs, dsts))
            self._cv.notify_all()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._jobs:
                    self._cv.wait()
                srcs, dsts = self._jobs.pop(0)
            t0 = time.perf_counter()
            self._host_to_disk(srcs, dsts)
            dt = time.perf_counter() - t0
            with self._cv:
                self.background_copy_s += dt
                self._bg_pending -= 1
                self.completed_pages_total += len(srcs)
                self._iter_completed += len(srcs)
                self._cv.notify_all()

    def _wait_bg(self) -> None:
        with self._cv:
            while self._bg_pending:
                self._cv.wait()
            self._bg_host.clear()
            self._bg_disk.clear()

    # ----- counters --------------------------------------------------------

    def inflight_pages(self) -> int:
        with self._cv:
            return self.issued_pages_total - self.completed_pages_total

    def take_iteration_counters(self) -> tuple[int, int]:
        """(issued, completed) page deltas since the last call — sampled
        once per iteration into the trace record."""
        with self._cv:
            out = (self._iter_issued, self._iter_completed)
            self._iter_issued = 0
            self._iter_completed = 0
        return out

    # ----- execution -------------------------------------------------------

    def _host_to_disk(self, srcs: list[int], dsts: list[int]) -> None:
        """One batch of host->disk page copies (distinct dst frames), on
        CPU memory only: the background worker runs this. Each page's bits
        move with one ``numpy.copyto`` (see the module docstring)."""
        for src, dst in zip(srcs, dsts):
            np.copyto(self._disk_bits[dst], self._host_bits[src])

    def _exec_group(self, kind: str, srcs: list[int],
                    dsts: list[int]) -> None:
        if kind == "d2h":
            ops.copy_pages_to_host(self._get_pool(), srcs,
                                   self.host_pool, dsts)
        elif kind == "h2d":
            self._set_pool(ops.copy_pages_from_host(
                self.host_pool, srcs, self._get_pool(), dsts))
        elif kind == "disk2h":
            self.host_pool.index_copy_(
                0, _ids(dsts), self.disk_pool.index_select(0, _ids(srcs)))
        elif kind == "h2disk":
            self._host_to_disk(srcs, dsts)
        elif kind == "disk2d":
            self._set_pool(ops.copy_pages_from_host(
                self.disk_pool, srcs, self._get_pool(), dsts))
        elif kind == "d2disk":
            ops.copy_pages_to_host(self._get_pool(), srcs,
                                   self.disk_pool, dsts)
        else:  # pragma: no cover
            raise ValueError(f"unknown copy kind {kind!r}")
