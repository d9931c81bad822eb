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
engine.

Each walk over the groups forks the side stream from the compute stream
and joins it back at the end, and every event the ring waits on is
recorded inside the same walk, so a walk can be captured whole into a
CUDA graph (``core.graphs``): the copies become memcpy nodes that read the
pinned offloaded stack ``place`` made.

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
from typing import Any

import torch

from repro_torch.core import graphs
from repro_torch.core.interval import OffloadPlan
from repro_torch.models import layers as L
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
    in group order, then ``end``."""

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
        self.ready = [torch.cuda.Event() for _ in range(2)]
        self.free = [torch.cuda.Event() for _ in range(2)]
        self.fork = torch.cuda.Event()
        self.join = torch.cuda.Event()
        self._released = [False, False]   # free[slot] recorded this walk
        self.copies = 0

    def begin(self) -> None:
        """Fork: the side stream starts after the work queued on the
        compute stream so far, which covers every read of the ring by
        earlier walks."""
        compute = torch.cuda.current_stream(self.device)
        if compute == self.stream:
            raise RuntimeError("the weight ring's side stream is the "
                               "compute stream: its copies would not "
                               "overlap the compute")
        self.fork.record(compute)
        self.stream.wait_event(self.fork)
        self._released = [False, False]

    def issue(self, g: int) -> int:
        """Start copying unit ``g`` into its ring slot; returns the slot."""
        slot = g % 2
        with torch.cuda.stream(self.stream):
            if self._released[slot]:
                # the compute that last read this slot must finish before
                # the slot is rewritten
                self.stream.wait_event(self.free[slot])
            tree_map(lambda d, h: d.copy_(h[g], non_blocking=True),
                     self.slots[slot], self.host)
            self.ready[slot].record(self.stream)
        self.copies += 1
        return slot

    def acquire(self, slot: int) -> Any:
        """The slot's unit, once the compute stream has waited for its copy."""
        torch.cuda.current_stream(self.device).wait_event(self.ready[slot])
        return self.slots[slot]

    def release(self, slot: int) -> None:
        """Mark the end of the compute that read the slot."""
        self.free[slot].record(torch.cuda.current_stream(self.device))
        self._released[slot] = True

    def end(self) -> None:
        """Join: the compute stream waits for the side stream's last
        operation (a capture fails on a fork left unjoined)."""
        self.join.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.join)


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
        self.host_weight_bytes = sum(t.numel() * t.element_size()
                                     for t in tree_leaves(off))
        return out

    # ---- the group walk shared by decode and prefill ------------------------
    def _walk(self, params_split: Params, x: torch.Tensor, apply_unit):
        """Run every unit in global order: per group, start the offloaded
        unit's copy, run the i-1 resident units, then the offloaded unit;
        then the tail. ``apply_unit(x, unit_params, unit_idx)`` returns
        (x, cache_or_None). Returns (x, caches split by placement)."""
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
            stream.begin()
        for gi in range(g):
            slot = stream.issue(gi) if stream is not None else None
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
            stream.end()
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
        in place, and each replay counts its prefetch copies. The capture's
        eager warm-up call is undone, so the caches hold what they held."""
        saved = tree_map(torch.clone, caches_split)
        counters = ([(self._stream, "copies")] if self._stream is not None
                    else [])
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
