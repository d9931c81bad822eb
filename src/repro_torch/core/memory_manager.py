"""Runtime memory manager (§4.3): applies an OffloadPlan to a model
(port of ``repro.core.memory_manager``).

The layer stack (pattern-period scan units, leaves stacked [R, ...]) is
re-grouped into

    resident  [G, i-1, ...]   -- device memory
    offloaded [G, ...]        -- pinned host memory (on a GPU)
    tail      [r, ...]        -- device memory (units after the last group)

and the step functions loop over the G groups. On a GPU, the offloaded unit
of group g is copied host-to-device on a side CUDA stream into one slot of a
two-slot device ring *when the group starts* (paper Fig. 7), so the i-1
resident units compute while the copy runs; the compute stream waits on the
copy's event just before the offloaded unit runs, and a copy into a slot
waits on the event that marks the end of the compute that last read it.
This is what the reference's ``device_put`` prefetch with device shardings
describes. On the CPU the prefetch is the identity, as in the reference
engine. The copies of units 0 and 1 start earlier: each walk ends by
priming the ring for the next (``WeightStream``), so they run under the
walk's tail and the host's work between walks.

Each walk over the groups forks the side stream from the compute stream
and joins it back at the end, and every event the ring waits on inside the
walk is recorded inside it, so a walk can be captured whole into a CUDA
graph (``core.graphs``): the copies become memcpy nodes that read the
pinned offloaded stack ``place`` made. Only the events that hand the
primed units from one walk to the next cross the graph's edge, as
external events.

``decode_step`` is the dense-cache grouped decode every model family runs
(attention, Mamba, mLSTM, sLSTM, and the encoder-decoder's cross
attention): the same walk, with each unit's slot-dense caches and
recurrent states split like the weights (``split_caches``). Where the
reference returns new caches, the port writes each unit's new cache into
the split tree in place and returns that tree, so a CUDA graph of the
step (``capture_decode``) updates the very buffers it was captured on.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Any

import torch

from repro_torch.core import graphs
from repro_torch.core.interval import OffloadPlan
from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.spec import TensorSpec, tree_leaves, tree_map

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Splitting stacked trees by plan
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (TensorSpec, torch.Tensor))


def _split_array(a: torch.Tensor, plan: OffloadPlan):
    g, i = plan.num_groups, plan.interval
    used = g * i if plan.enabled else 0
    if plan.enabled:
        head = a[:used].reshape(g, i, *a.shape[1:])
        resident = head[:, : i - 1]
        offloaded = head[:, i - 1]
    else:
        resident = a[:0].reshape(0, 1, *a.shape[1:])
        offloaded = a[:0]
    return resident, offloaded, a[used:]


def _split_spec(s: TensorSpec, plan: OffloadPlan):
    g, i = plan.num_groups, plan.interval
    r = s.shape[0]
    rest, logical = s.shape[1:], s.logical[1:]
    mk = lambda lead: dataclasses.replace(
        s, shape=(*lead, *rest), logical=("stack",) * len(lead) + logical,
        fan_in_axes=tuple(a + len(lead) - 1 for a in s.fan_in_axes))
    if plan.enabled:
        return mk((g, i - 1)), mk((g,)), mk((r - g * i,))
    return mk((0, 1)), mk((0,)), mk((r,))


def split_stacked(tree: Any, plan: OffloadPlan) -> dict[str, Any]:
    """Split every leaf (leading dim R) into the three placement groups."""
    def split(leaf):
        if isinstance(leaf, TensorSpec):
            return _split_spec(leaf, plan)
        return _split_array(leaf, plan)

    parts = tree_map(split, tree, is_leaf=_is_leaf)
    pick = lambda k: tree_map(
        lambda p: p[k], parts,
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3)
    return {"resident": pick(0), "offloaded": pick(1), "tail": pick(2)}


def split_model_params(params: Params, plan: OffloadPlan) -> Params:
    """Model params/spec tree -> offload layout (blocks replaced)."""
    out = dict(params)
    out["blocks"] = split_stacked(params["blocks"], plan)
    return out


def merge_stacked(split: Any, plan: OffloadPlan) -> Any:
    """Inverse of split_stacked for tensor trees: placement sections back to
    one [R, ...] stack in unit order. Sections may be None (the prefill path
    returns None for empty placements) or zero-length tensors."""
    g, i = plan.num_groups, plan.interval
    res, off, tail = split["resident"], split["offloaded"], split["tail"]
    if not plan.enabled or (res is None and off is None):
        assert tail is not None
        return tail
    if res is None:          # interval == 1: every unit in a group offloaded
        head = off
    else:
        head = tree_map(
            lambda r, o: torch.cat([r, o[:, None]], dim=1)
            .reshape(g * i, *r.shape[2:]), res, off)
    if tail is None:
        return head
    return tree_map(lambda h, t: torch.cat([h, t], dim=0), head, tail)


def merge_model_params(split: Params, plan: OffloadPlan) -> Params:
    """Inverse of split_model_params (tensors only)."""
    out = dict(split)
    out["blocks"] = merge_stacked(split["blocks"], plan)
    return out


# ---------------------------------------------------------------------------
# Weight streaming
# ---------------------------------------------------------------------------


class WeightStream:
    """Two-slot device ring fed from the pinned-host offloaded stack
    ``[G, ...]`` on a side CUDA stream (see the module docstring). A walk
    calls ``begin``, then per group ``issue``, ``acquire`` and ``release``
    in group order, then ``end``.

    ``OffloadRuntime``'s walks (``begin_walk`` / ``fetch`` / ``end_walk``)
    also keep the host link busy between walks: each ends by *priming* the
    ring (``prime``), issuing units 0 and 1 (unit 0 alone when G is 1)
    into their slots once the walk's last reads of those slots have run,
    so their copies run under the walk's tail and the host's work before
    the next walk, which takes them without issuing them. Every walk at
    one placement reads the units in the same order, so the rule holds for
    decode, prefill and chunk walks alike. Between two walks, units 0 and
    1 are in the ring or on their way. The events that cross from one walk
    to the next are external (``landed``: a primed copy has run;
    ``vacated``: a walk's last read of a slot has run), so a walk captured
    into a CUDA graph waits on and records them at every replay; the host
    primes after each replay (``graphs.around_replay``). ``place`` primes
    a new ring. A walk begun with ``begin`` (a caller's own issues) drops
    the priming, since it may overwrite both slots.

    ``copies`` counts the units issued, priming included, and
    ``copy_bytes`` their bytes; ``walks`` counts the walks and
    ``primed_walks`` those whose first units a previous walk primed.
    With ``timed`` set, a walk also records three timing events per group
    ``g``: ``copy_start`` on the side stream once the slot is free,
    ``copy_end`` beside ``ready``, and ``reach`` on the compute stream just
    before it waits for the copy. They are external events, so a CUDA
    graph captured from a timed walk records them at every replay;
    ``timings`` reads them once the walk has completed. A priming copy
    always records its own pair of events, in one of two sets that
    alternate, so the next walk's priming leaves this walk's readable."""

    def __init__(self, host_units: Any, device: torch.device):
        self.host = host_units
        self.device = device
        # high priority: PyTorch hands out default-priority streams round
        # robin from a pool of 32, so a default one can be the very stream
        # a CUDA graph is captured on, and the ring's copies would then
        # run in line with the compute instead of beside it
        self.stream = torch.cuda.Stream(device, priority=-1)
        self.slots = [tree_map(lambda t: torch.empty(
            t.shape[1:], dtype=t.dtype, device=device), host_units)
            for _ in range(2)]
        self.groups = tree_leaves(host_units)[0].shape[0]
        self.n_prime = min(2, self.groups)
        self.ready = [torch.cuda.Event() for _ in range(2)]
        self.free = [torch.cuda.Event() for _ in range(2)]
        self.landed = [torch.cuda.Event(external=True) for _ in range(2)]
        self.vacated = [torch.cuda.Event(external=True) for _ in range(2)]
        self.fork = torch.cuda.Event()
        self.join = torch.cuda.Event()
        self._released = [False, False]   # free[slot] recorded this walk
        self._group = [0, 0]              # the group issued into each slot
        self._from_prime = [False, False]  # this walk's unit came primed
        self._primed = 0                  # units primed, not yet walked
        self._primed_by_walk = False      # ... by the end of a walk
        self._after_compute = True        # prime after all queued compute
        self._walk_primed = 0             # units the last walk took primed
        self._prime_set = 0               # the priming's timing event set
        self._walk_set = 0                # ... that the last walk took
        self._prime_events: list | None = None
        self.copies = 0
        self.unit_bytes = sum(t.numel() * t.element_size()
                              for t in tree_leaves(self.slots[0]))
        self.copy_bytes = 0
        self.walks = 0
        self.primed_walks = 0
        self.timed = False
        self._events: tuple[list, list, list] | None = None

    def _timing_events(self) -> tuple[list, list, list]:
        """(copy_start, copy_end, reach), one event per group each, made
        at the first timed walk."""
        if self._events is None:
            self._events = tuple(
                [torch.cuda.Event(enable_timing=True, external=True)
                 for _ in range(self.groups)] for _ in range(3))
        return self._events

    def _fork(self) -> None:
        """The side stream starts after the work queued on the compute
        stream so far, which covers every read of the ring by earlier
        walks."""
        compute = torch.cuda.current_stream(self.device)
        if compute == self.stream:
            raise RuntimeError("the weight ring's side stream is the "
                               "compute stream: its copies would not "
                               "overlap the compute")
        self.fork.record(compute)
        self.stream.wait_event(self.fork)
        self._released = [False, False]
        self._from_prime = [False, False]

    def begin(self) -> None:
        """Fork (``_fork``) for a walk whose units the caller issues: it
        drops the priming, and the next priming starts after the compute
        queued by then."""
        self._fork()
        self._primed = 0
        self._after_compute = True

    def begin_walk(self) -> None:
        """Fork for one of ``OffloadRuntime``'s walks and take the units a
        priming issued. A walk being captured into a graph only waits for
        them: each replay of the graph takes the units primed before it,
        and the host primes again after it (``graphs.around_replay``)."""
        self._fork()
        if torch.cuda.is_current_stream_capturing():
            if self._primed != self.n_prime:
                raise RuntimeError("a captured walk needs a primed weight "
                                   "ring (Graphed's eager warm-up primes "
                                   "it)")
            graphs.around_replay(self, self._before_replay,
                                 self._after_replay)
            self._walk_primed = self._primed
        else:
            self._take()
        for slot in range(self._walk_primed):
            self._from_prime[slot] = True
            self._group[slot] = slot

    def _take(self) -> None:
        """A walk takes the primed units: count it."""
        self.walks += 1
        self.primed_walks += int(self._primed > 0 and self._primed_by_walk)
        self._walk_primed, self._walk_set = self._primed, self._prime_set
        self._primed = 0

    def fetch(self, g: int) -> int:
        """Unit ``g``'s slot in a walk begun by ``begin_walk``: issued now,
        unless a priming issued it."""
        return g % 2 if g < self._walk_primed else self.issue(g)

    def end_walk(self) -> None:
        """Join (``end``); then, outside a capture, prime the next walk.
        The priming copies are not joined: a caller's sync does not wait
        for them."""
        self.end()
        if not torch.cuda.is_current_stream_capturing():
            self._prime(by_walk=True)

    def _before_replay(self) -> None:
        # a walk begun by ``begin`` used the slots since the last priming
        if self._primed != self.n_prime:
            self.prime()

    def _after_replay(self) -> None:
        self._take()
        self._prime(by_walk=True)

    def prime(self) -> None:
        """Issue units 0 and 1 (unit 0 alone when G is 1) into their
        slots, after the compute queued so far, for the next walk to take
        (``begin_walk``). ``place`` primes a new ring."""
        self._after_compute = True
        self._prime(by_walk=False)

    def _prime(self, by_walk: bool) -> None:
        """Each priming copy starts once its slot is free: after the last
        walk's last read of the slot (``vacated``), or after all compute
        queued so far when no walk of this ring has ended since it was made
        or used by ``begin``."""
        if self._prime_events is None:
            self._prime_events = [
                [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                 for _ in range(self.n_prime)] for _ in range(2)]
        self._prime_set ^= 1
        events = self._prime_events[self._prime_set]
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            if self._after_compute:
                self.fork.record(compute)
                self.stream.wait_event(self.fork)
            for g in range(self.n_prime):
                if not self._after_compute:
                    self.stream.wait_event(self.vacated[g])
                events[g][0].record(self.stream)
                tree_map(lambda d, h: d.copy_(h[g], non_blocking=True),
                         self.slots[g], self.host)
                # before ``landed``: a walk that waited for the copy can
                # read the copy's time
                events[g][1].record(self.stream)
                self.landed[g].record(self.stream)
        self.copies += self.n_prime
        self.copy_bytes += self.n_prime * self.unit_bytes
        self._primed, self._primed_by_walk = self.n_prime, by_walk
        self._after_compute = False

    def issue(self, g: int) -> int:
        """Start copying unit ``g`` into its ring slot; returns the slot."""
        slot = g % 2
        self._group[slot] = g
        self._from_prime[slot] = False
        timing = self._timing_events() if self.timed else None
        with torch.cuda.stream(self.stream):
            if self._released[slot]:
                # the compute that last read this slot must finish before
                # the slot is rewritten
                self.stream.wait_event(self.free[slot])
            if timing:
                timing[0][g].record(self.stream)
            tree_map(lambda d, h: d.copy_(h[g], non_blocking=True),
                     self.slots[slot], self.host)
            self.ready[slot].record(self.stream)
            if timing:
                timing[1][g].record(self.stream)
        self.copies += 1
        self.copy_bytes += self.unit_bytes
        return slot

    def acquire(self, slot: int) -> Any:
        """The slot's unit, once the compute stream has waited for its copy."""
        compute = torch.cuda.current_stream(self.device)
        if self.timed:
            self._timing_events()[2][self._group[slot]].record(compute)
        compute.wait_event(self.landed[slot] if self._from_prime[slot]
                           else self.ready[slot])
        return self.slots[slot]

    def release(self, slot: int) -> None:
        """Mark the end of the compute that read the slot; after the
        slot's last group, also for the next walk's priming."""
        compute = torch.cuda.current_stream(self.device)
        self.free[slot].record(compute)
        self._released[slot] = True
        if self._group[slot] + 2 >= self.groups:
            self.vacated[slot].record(compute)

    def end(self) -> None:
        """Join: the compute stream waits for the side stream's last
        operation (a capture fails on a fork left unjoined)."""
        self.join.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.join)

    def drain(self) -> None:
        """The compute stream waits for every copy queued on the side
        stream, a priming's too, so that memory freed after it is not
        handed out while a copy into it is queued."""
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def __del__(self):
        # a ring dropped while primed: its slots are freed right after this
        if self.device.type == "cuda" and not sys.is_finalizing():
            self.drain()

    def timings(self) -> list[tuple[float, float]]:
        """Per group of the last timed walk, once it has completed: the
        copy's ms (``copy_end - copy_start``) and how long the compute
        stream waited for it (``max(0, copy_end - reach)``). A primed
        group's copy is the priming's, which started before the walk."""
        start, end, reach = (list(e) for e in self._timing_events())
        for g in range(self._walk_primed):
            start[g], end[g] = self._prime_events[self._walk_set][g]
        return [(s.elapsed_time(e), max(0.0, r.elapsed_time(e)))
                for s, e, r in zip(start, end, reach)]


def offload_memory_kind_fn(path: tuple) -> str | None:
    """memory_kind for spec.shardings(): pinned_host under blocks/offloaded.
    ``path`` is a leaf's dict keys and list indices."""
    keys = list(path)
    if "blocks" in keys:
        i = keys.index("blocks")
        if i + 1 < len(keys) and keys[i + 1] == "offloaded":
            return "pinned_host"
    return None


# ---------------------------------------------------------------------------
# Grouped step functions
# ---------------------------------------------------------------------------


class OffloadRuntime:
    """Bundles a model + plan into offload-aware step callables on one
    device. ``place`` puts a split parameter tree where the plan says:
    on a GPU the offloaded units go to pinned host memory and everything
    else to the device; on the CPU nothing moves."""

    def __init__(self, model: Model, plan: OffloadPlan,
                 device: torch.device | str = "cuda"):
        self.model = model
        self.plan = plan
        self.device = torch.device(device)
        self._stream: WeightStream | None = None
        self.host_weight_bytes = 0     # pinned-host bytes of placed units

    @property
    def prefetch_copies(self) -> int:
        """Offloaded units copied host-to-device so far."""
        return self._stream.copies if self._stream is not None else 0

    @property
    def walks(self) -> int:
        """Walks over the weight ring so far (``WeightStream.walks``)."""
        return self._stream.walks if self._stream is not None else 0

    @property
    def primed_walks(self) -> int:
        """Walks that found their first units primed by a previous walk."""
        return self._stream.primed_walks if self._stream is not None else 0

    def place(self, params_split: Params) -> Params:
        if self.device.type != "cuda":
            return params_split
        dev = lambda t: t.to(self.device)
        out = tree_map(dev, {k: v for k, v in params_split.items()
                             if k != "blocks"})
        blk = params_split["blocks"]
        off = tree_map(lambda t: t.to("cpu").contiguous().pin_memory(),
                       blk["offloaded"])
        out["blocks"] = {"resident": tree_map(dev, blk["resident"]),
                         "offloaded": off, "tail": tree_map(dev, blk["tail"])}
        if self.plan.num_groups > 0:
            self._stream = WeightStream(off, self.device)
            self._stream.prime()
        self.host_weight_bytes = sum(t.numel() * t.element_size()
                                     for t in tree_leaves(off))
        return out

    # ---- the group walk shared by decode and prefill ------------------------
    def _walk(self, params_split: Params, x: torch.Tensor, apply_unit):
        """Run every unit in global order: per group, start the offloaded
        unit's copy (units 0 and 1 were started by the ring's priming), run
        the i-1 resident units, then the offloaded unit; then the tail, while
        the ring primes the next walk. ``apply_unit(x, unit_params,
        unit_idx)`` returns (x, cache_or_None). Returns (x, caches split by
        placement)."""
        blk = params_split["blocks"]
        g, iv = self.plan.num_groups, self.plan.interval
        stream = None
        if g > 0 and self.device.type == "cuda":
            stream = self._stream
            if stream is None or stream.host is not blk["offloaded"]:
                raise ValueError("on a GPU, pass the parameter tree that "
                                 "this runtime's place() returned")
        res_c, off_c = [], []
        if stream is not None:
            stream.begin_walk()
        for gi in range(g):
            slot = stream.fetch(gi) if stream is not None else None
            group = []
            for j in range(iv - 1):
                x, c = apply_unit(x, T.unit_slice(
                    T.unit_slice(blk["resident"], gi), j), gi * iv + j)
                group.append(c)
            res_c.append(group)
            if stream is not None:
                off_p = stream.acquire(slot)
            else:
                off_p = T.unit_slice(blk["offloaded"], gi)
            x, c = apply_unit(x, off_p, gi * iv + iv - 1)
            if stream is not None:
                stream.release(slot)
            off_c.append(c)
        if stream is not None:
            stream.end_walk()
        n_tail = tree_leaves(blk["tail"])[0].shape[0]
        tail_c = []
        for t in range(n_tail):
            x, c = apply_unit(x, T.unit_slice(blk["tail"], t), g * iv + t)
            tail_c.append(c)
        return x, {"resident": res_c, "offloaded": off_c, "tail": tail_c}

    def _cache_at(self, caches_split: Any, unit_idx: int) -> Any:
        """Unit ``unit_idx``'s caches: views into the split tree."""
        g, iv = self.plan.num_groups, self.plan.interval
        if unit_idx >= g * iv:
            return T.unit_slice(caches_split["tail"], unit_idx - g * iv)
        gi, j = divmod(unit_idx, iv)
        if j < iv - 1:
            return T.unit_slice(T.unit_slice(caches_split["resident"], gi), j)
        return T.unit_slice(caches_split["offloaded"], gi)

    # ----- dense-cache decode ---------------------------------------------------
    def decode_step(self, params_split: Params, tokens: torch.Tensor,
                    pos: torch.Tensor, caches_split: Any,
                    enc_pos: torch.Tensor | None = None):
        """One token for every row, through slot-dense caches split by
        placement (``split_caches``, or the caches ``prefill`` returns).
        Same group walk as ``paged_decode_step``: each group's offloaded
        unit is prefetched on the side stream while its i-1 resident units
        compute. Each unit's new caches (KV written at ``pos % cache_len``,
        recurrent states advanced) are copied into ``caches_split`` in
        place. tokens/pos: [B]. Returns (logits [B, V], caches_split)."""
        cfg, vkv = self.model.cfg, self.model.virtual_kv

        def apply_unit(x, pslices, unit_idx):
            cs = self._cache_at(caches_split, unit_idx)
            for j, blk in enumerate(cfg.pattern):
                x, nc = T.apply_block_decode(cfg, blk, pslices[j], x, pos,
                                             cs[j], vkv, enc_pos)
                tree_map(lambda dst, src: dst if dst is src
                         else dst.copy_(src), cs[j], nc)
            return x, None

        x = T.embed_tokens(cfg, params_split, tokens[:, None])
        x, _ = self._walk(params_split, x, apply_unit)
        x = L.apply_norm(cfg, params_split["final_norm"], x)
        logits = T.lm_logits(cfg, params_split, x)[:, 0]
        return logits, caches_split

    def capture_decode(self, params_split: Params, tokens: torch.Tensor,
                       pos: torch.Tensor, caches_split: Any,
                       enc_pos: torch.Tensor | None = None) -> graphs.Graphed:
        """``decode_step`` over these very tensors captured into one CUDA
        graph (GPU only; one per runtime, i.e. per interval): callers
        write the next tokens and positions into ``tokens`` / ``pos``,
        ``replay()`` returns (logits, caches_split) and advances the caches
        in place, and each replay counts its prefetch copies and primes the
        ring for the next walk. The capture's eager warm-up call is undone,
        so the caches hold what they held."""
        saved = tree_map(torch.clone, caches_split)
        counters = ([(self._stream, "copies"), (self._stream, "copy_bytes")]
                    if self._stream is not None else [])
        graph = graphs.Graphed(
            functools.partial(self.decode_step, params_split),
            (tokens, pos, caches_split, enc_pos), counters)
        tree_map(lambda dst, src: dst.copy_(src), caches_split, saved)
        return graph

    # ----- paged decode ---------------------------------------------------------
    def paged_decode_step(self, params_split: Params, tokens: torch.Tensor,
                          pos: torch.Tensor, pool: torch.Tensor,
                          block_tables: torch.Tensor,
                          context_lens: torch.Tensor,
                          write_frames: torch.Tensor,
                          write_offsets: torch.Tensor):
        """One decode iteration through the physical KV page pool.

        ``pool`` is the single [frames, page, L, 2, vh, hd] buffer the paged
        decode kernel indexes through ``block_tables``; each unit writes the
        new token's K/V at (write_frames, write_offsets) for its global
        layer index, in place, and attends over ``context_lens`` tokens.
        Returns (logits, pool)."""
        cfg, vkv = self.model.cfg, self.model.virtual_kv
        pat = len(cfg.pattern)
        wf, wo = write_frames.long(), write_offsets.long()

        def apply_unit(x, pslices, unit_idx):
            for j, blk in enumerate(cfg.pattern):
                x, _ = T.apply_block_decode_paged(
                    cfg, blk, pslices[j], x, pos, pool, unit_idx * pat + j,
                    block_tables, context_lens, wf, wo, vkv)
            return x, None

        x = T.embed_tokens(cfg, params_split, tokens[:, None])
        x, _ = self._walk(params_split, x, apply_unit)
        x = L.apply_norm(cfg, params_split["final_norm"], x)
        logits = T.lm_logits(cfg, params_split, x)[:, 0]
        return logits, pool

    # ----- paged chunk prefill --------------------------------------------------
    def paged_prefill_chunk(self, params_split: Params, tokens: torch.Tensor,
                            start: int, pool: torch.Tensor,
                            block_table: torch.Tensor, context_len: int,
                            write_frames: torch.Tensor,
                            write_offsets: torch.Tensor):
        """One incremental prefill chunk through the physical KV page pool.

        ``tokens``: [C] — the chunk at absolute positions
        ``start..start+C-1`` of one request. Same group walk as
        ``paged_decode_step`` (each group's offloaded unit is prefetched on
        the side stream while its resident units compute), but each unit
        writes the chunk's K/V at (write_frames, write_offsets) [C], in
        place, and attends the chunk's queries over the request's resident
        context through ``block_table`` [nb] / ``context_len`` — no prefix
        recompute. Returns (last-position logits [1, V], pool)."""
        cfg, vkv = self.model.cfg, self.model.virtual_kv
        pat = len(cfg.pattern)
        wf, wo = write_frames.long(), write_offsets.long()

        def apply_unit(x, pslices, unit_idx):
            for j, blk in enumerate(cfg.pattern):
                x, _ = T.apply_block_prefill_paged(
                    cfg, blk, pslices[j], x, start, pool, unit_idx * pat + j,
                    block_table, context_len, wf, wo, vkv)
            return x, None

        x = T.embed_tokens(cfg, params_split, tokens[None])    # [1, C, D]
        x, _ = self._walk(params_split, x, apply_unit)
        x = L.apply_norm(cfg, params_split["final_norm"], x)
        logits = T.lm_logits(cfg, params_split, x[:, -1:])[:, 0]
        return logits, pool

    # ----- prefill --------------------------------------------------------------
    def prefill(self, params_split: Params, inputs: dict, cache_len: int,
                attn_impl: str = "flash", last_pos: int | None = None):
        """Returns (logits [B,V] at ``last_pos``, caches split by placement
        ({"resident": [G, i-1, ...], "offloaded": [G, ...], "tail":
        [r, ...]} per pattern position, None for empty sections), enc_pos).
        ``inputs`` as ``Model.forward`` takes them: tokens, and the
        frontend's or the encoder's embeddings."""
        cfg, model = self.model.cfg, self.model
        enc_out = enc_pos = None
        if cfg.encoder_layers > 0:
            enc_out, enc_pos = model.encode(params_split, inputs["enc_embeds"],
                                            attn_impl)
        x = model.embed_inputs(params_split, inputs)
        b, s, _ = x.shape
        posm = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        ctx = T.SeqCtx(positions=posm, want_cache=True, cache_len=cache_len,
                       virtual_kv=model.virtual_kv, enc_out=enc_out,
                       enc_pos=enc_pos, attn_impl=attn_impl)

        def apply_unit(x, pslices, _unit_idx):
            caches = []
            for j, blk in enumerate(cfg.pattern):
                x, c, _a = T.apply_block_seq(cfg, blk, pslices[j], x, ctx)
                caches.append(c)
            return x, caches

        x, parts = self._walk(params_split, x, apply_unit)
        stack = lambda units: (tree_map(lambda *xs: torch.stack(xs), *units)
                               if units else None)
        caches: dict[str, Any] = {"resident": None, "offloaded": None}
        if self.plan.num_groups > 0:
            if self.plan.interval > 1:
                caches["resident"] = stack([stack(grp)
                                            for grp in parts["resident"]])
            caches["offloaded"] = stack(parts["offloaded"])
        caches["tail"] = stack(parts["tail"])
        x = L.apply_norm(cfg, params_split["final_norm"], x)
        # last_pos: logits position for shape-bucketed prefills whose tokens
        # carry suffix padding (causal attention keeps every position < S
        # bitwise-independent of the padding; the last ROW is padding)
        h = x[:, -1:] if last_pos is None else x[:, last_pos:last_pos + 1]
        logits = T.lm_logits(cfg, params_split, h)[:, 0]
        return logits, caches, enc_pos

    # ----- cache helpers ---------------------------------------------------------
    def split_caches(self, caches: Any):
        """Stacked [R, ...] caches -> the placement split (views, no copy)."""
        return split_stacked(caches, self.plan)

    def cache_spec_split(self, batch: int, cache_len: int, enc_len: int = 0):
        return split_stacked(
            self.model.cache_spec(batch, cache_len, enc_len), self.plan)

    def spec_split(self) -> Params:
        return split_model_params(self.model.spec, self.plan)

    # ----- accounting -------------------------------------------------------
    def memory_report(self) -> dict:
        from repro_torch.core import costs
        ub = costs.unit_weight_bytes(self.model.cfg)
        p, r = T.pattern_info(self.model.cfg)
        other = S.tree_bytes(self.model.spec) - ub * r
        return {
            "unit_bytes": ub,
            "host_bytes": self.plan.host_bytes(ub),
            "device_stack_bytes": self.plan.device_bytes(ub),
            "device_other_bytes": other,
            "link_bytes_per_iter": self.plan.link_bytes_per_iter(ub),
        }
