"""Offline performance analyzer (§4.4), port of ``repro.core.analyzer``.

Runs on a dedicated machine with no bus contention. For every (batch, seq)
bucket it obtains per-layer compute time — *measured*, never estimated from
peak FLOPs (Observation #2) — plus the layer transfer time, and tabulates the
optimal offloading interval for every SLO on the 2 ms grid.

Two measurement modes:
  * "wallclock": time one scan unit on ``device`` (the default; the GPU
    unless the caller asks for the CPU), on a GPU as a replay of a CUDA
    graph captured from the unit, as the reference times its jitted unit.
    The prefill unit runs the flash kernel, as the reference's unit does
    its flash-equivalent attention; the decode unit runs the engine's own
    per-layer call, ``apply_block_decode_paged``, through the paged decode
    kernel over a page pool in the engine's layout, where the reference
    times its dense-cache oracle (ROADMAP Queue C: both compute the same
    values);
  * "model":     analytic roofline estimate from the hardware preset
    (recorded in the record's provenance field).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs, graphs
from repro_torch.core.hardware import HardwareModel
from repro_torch.core.interval import LayerTimes, optimal_interval
from repro_torch.core.record import PerformanceRecord
from repro_torch.models import transformer as T
from repro_torch.models.model import Model, build_model

# tokens per page of the timed decode unit's pool (the engine's default)
DECODE_PAGE = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn: Callable, *args, repeats: int = 3,
             device: torch.device = torch.device("cpu")) -> float:
    """One warm-up call, then the median wall time of ``repeats`` calls. On
    a GPU the warm-up is the capture of ``fn`` into a CUDA graph
    (``core.graphs``, the reference's ``jax.jit``) and each call a replay
    of it, with the device synchronized before each start and after each
    call (the reference's ``jax.block_until_ready``); the graph is freed
    when the function returns."""
    if device.type == "cuda":
        call = graphs.Graphed(fn, args).replay
    else:
        fn(*args)
        call = lambda: fn(*args)
    _sync(device)
    ts = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        call()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class MeasuredTimes:
    t_compute_s: float       # one scan unit (pattern period)
    t_transfer_s: float      # one scan unit's weights over the host link
    t_rest_s: float
    unit_bytes: int
    num_units: int


@dataclasses.dataclass
class PagedDecodeInputs:
    """One decode step of ``batch`` rows through a page pool: every row at
    position ``seq - 1`` over a context of ``seq`` tokens in frames of its
    own, writing the new token's K/V at that position."""
    pool: torch.Tensor            # [frames, page, L, 2, vh, hd] bf16
    block_tables: torch.Tensor    # [B, ceil(seq / page)] int32
    context_lens: torch.Tensor    # [B] int32
    write_frames: torch.Tensor    # [B] int64
    write_offsets: torch.Tensor   # [B] int64
    pos: torch.Tensor             # [B] int32


def decode_pool(cfg: ModelConfig, virtual_kv: int, batch: int, seq: int,
                device: torch.device | str) -> torch.Tensor:
    """A zeroed page pool in the engine's layout, all ``cfg.num_layers``
    layers per frame, so a kernel reads the engine's layer strides; it
    holds ``batch`` rows of ``seq`` tokens in ``DECODE_PAGE``-token pages."""
    return torch.zeros((batch * -(-seq // DECODE_PAGE), DECODE_PAGE,
                        cfg.num_layers, 2, virtual_kv, cfg.resolved_head_dim),
                       dtype=torch.bfloat16, device=device)


def paged_decode_inputs(pool: torch.Tensor, batch: int,
                        seq: int) -> PagedDecodeInputs:
    """Row b holds frames ``b * nb .. b * nb + nb - 1`` of ``pool``."""
    page = pool.shape[1]
    nb = -(-seq // page)
    if batch * nb > pool.shape[0]:
        raise ValueError(f"pool of {pool.shape[0]} frames cannot hold "
                         f"{batch} rows of {nb} pages")
    dev = pool.device
    bt = torch.arange(batch * nb, dtype=torch.int32,
                      device=dev).reshape(batch, nb)
    return PagedDecodeInputs(
        pool=pool, block_tables=bt,
        context_lens=torch.full((batch,), seq, dtype=torch.int32, device=dev),
        write_frames=bt[:, (seq - 1) // page].long(),
        write_offsets=torch.full((batch,), (seq - 1) % page, dtype=torch.long,
                                 device=dev),
        pos=torch.full((batch,), seq - 1, dtype=torch.int32, device=dev))


def prefill_unit(m1: Model, params, tokens: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """The timed prefill unit: embed, then the stack through the flash
    kernel. Returns the hidden state [B, S, D]."""
    x = T.embed_tokens(m1.cfg, params, tokens)
    ctx = T.SeqCtx(positions=pos, virtual_kv=m1.virtual_kv, attn_impl="flash")
    x, _, _ = T.apply_stack_seq(m1.cfg, params["blocks"], x, ctx)
    return x


def decode_unit(m1: Model, params, tokens: torch.Tensor,
                d: PagedDecodeInputs) -> torch.Tensor:
    """The timed decode unit: embed, then every block of the stack through
    ``apply_block_decode_paged`` (unit u's block j reads pool layer
    ``u * len(pattern) + j``). Returns the hidden state [B, 1, D]."""
    cfg = m1.cfg
    pat, r = T.pattern_info(cfg)
    x = T.embed_tokens(cfg, params, tokens[:, None])
    for u in range(r):
        ps = T.unit_slice(params["blocks"], u)
        for j, blk in enumerate(cfg.pattern):
            x, _ = T.apply_block_decode_paged(
                cfg, blk, ps[j], x, d.pos, d.pool, u * pat + j,
                d.block_tables, d.context_lens, d.write_frames,
                d.write_offsets, m1.virtual_kv)
    return x


class PerformanceAnalyzer:
    def __init__(self, cfg: ModelConfig, hw: HardwareModel,
                 measure: str = "wallclock", link_share: float = 1.0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.hw = hw
        self.measure = measure
        self.link_share = link_share
        self.device = torch.device(device)
        self.model = build_model(cfg)
        self._params_one = None  # single-unit params, lazily built
        self._pool: torch.Tensor | None = None
        # what generate_record measured: (phase, batch, seq) -> MeasuredTimes
        self.bucket_times: dict[tuple[str, int, int], MeasuredTimes] = {}

    # ---- per-(batch, seq) measurement ---------------------------------------
    def _single_unit_params(self):
        if self._params_one is None:
            cfg1 = dataclasses.replace(self.cfg,
                                       num_layers=len(self.cfg.pattern))
            m1 = build_model(cfg1)
            gen = torch.Generator(self.device).manual_seed(0)
            self._params_one = (m1, m1.init(gen, self.device))
        return self._params_one

    def _decode_pool(self, batch: int, seq: int) -> torch.Tensor:
        """The decode unit's pool, reallocated only when a bucket needs more
        frames (``generate_record`` sizes it for its largest bucket)."""
        if (self._pool is None
                or self._pool.shape[0] < batch * -(-seq // DECODE_PAGE)):
            self._pool = None
            self._pool = decode_pool(self.cfg, self.model.virtual_kv, batch,
                                     seq, self.device)
        return self._pool

    def unit_call(self, batch: int, seq: int,
                  phase: str) -> tuple[Callable, tuple]:
        """The wall-clock mode's timed unit at (batch, seq) and its
        arguments: ``prefill_unit`` over ``seq`` zero tokens per row, or
        ``decode_unit`` at position ``seq - 1`` through the pool."""
        m1, params1 = self._single_unit_params()
        dev = self.device
        if phase == "prefill":
            tokens = torch.zeros((batch, seq), dtype=torch.int32, device=dev)
            pos = torch.arange(seq, dtype=torch.int32,
                               device=dev).expand(batch, seq)
            return prefill_unit, (m1, params1, tokens, pos)
        tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return decode_unit, (m1, params1, tok, paged_decode_inputs(
            self._decode_pool(batch, seq), batch, seq))

    def measure_times(self, batch: int, seq: int, phase: str) -> MeasuredTimes:
        cfg = self.cfg
        p, r = T.pattern_info(cfg)
        unit_bytes = costs.unit_weight_bytes(cfg)
        # Per-device transferred bytes scale with the TP shard; the analyzer
        # works in whole-instance terms (every host moves its shard in
        # parallel), so full unit bytes over one link is the faithful unit.
        t_transfer = self.hw.transfer_time(unit_bytes, self.link_share)

        if self.measure == "model":
            if phase == "prefill":
                fl = sum(costs.layer_flops(cfg, batch, seq, seq, j)
                         for j in range(p))
                by = sum(costs.layer_act_bytes(cfg, batch, seq, seq, j)
                         for j in range(p))
            else:
                fl = sum(costs.layer_flops(cfg, batch, 1, seq, j)
                         for j in range(p))
                by = sum(costs.layer_act_bytes(cfg, batch, 1, seq, j)
                         for j in range(p))
            t_compute = self.hw.exec_time(fl, by)
            rest = self.hw.exec_time(
                2 * batch * (seq if phase == "prefill" else 1)
                * cfg.d_model * cfg.padded_vocab(),
                cfg.padded_vocab() * cfg.d_model * 2)
            return MeasuredTimes(t_compute, t_transfer, rest, unit_bytes, r)

        # wallclock: run one scan unit for real
        fn, args = self.unit_call(batch, seq, phase)
        t_unit = _time_fn(fn, *args, device=self.device)
        return MeasuredTimes(t_unit, t_transfer, 0.1 * t_unit, unit_bytes, r)

    def layer_times(self, batch: int, seq: int, phase: str) -> LayerTimes:
        return _layer_times(self.measure_times(batch, seq, phase))

    # ---- record generation ----------------------------------------------------
    def generate_record(self, slos_s: Sequence[float], batches: Sequence[int],
                        seqs: Sequence[int], phase: str) -> PerformanceRecord:
        rec = PerformanceRecord(
            model_name=self.cfg.name, hardware=self.hw.name, phase=phase,
            batches=sorted(batches), seqs=sorted(seqs), measure=self.measure)
        if self.measure == "wallclock" and phase == "decode":
            self._decode_pool(rec.batches[-1], rec.seqs[-1])
        for b in rec.batches:
            for s in rec.seqs:
                mt = self.bucket_times[(phase, b, s)] = self.measure_times(
                    b, s, phase)
                times = _layer_times(mt)
                for slo in slos_s:
                    rec.set(slo, b, s, optimal_interval(times, slo))
        return rec


def _layer_times(mt: MeasuredTimes) -> LayerTimes:
    return LayerTimes(
        t_compute_s=mt.t_compute_s, t_transfer_s=mt.t_transfer_s,
        num_layers=mt.num_units, layer_bytes=mt.unit_bytes,
        t_rest_s=mt.t_rest_s)


def unit_time_stats(an: PerformanceAnalyzer, batch: int, seq: int,
                    phase: str, iters: int = 5) -> dict:
    """Mean, standard deviation and coefficient of variation of ``iters``
    measurements of one unit."""
    ts = np.asarray([an.measure_times(batch, seq, phase).t_compute_s
                     for _ in range(iters)])
    return {"mean_s": float(ts.mean()), "std_s": float(ts.std()),
            "cv": float(ts.std() / ts.mean())}


def determinism_check(cfg: ModelConfig, batch: int, seq: int,
                      iters: int = 5,
                      device: torch.device | str = "cuda") -> dict:
    """Empirically verify the paper's premise: per-iteration layer compute
    time is deterministic (CV below a few percent)."""
    an = PerformanceAnalyzer(cfg, hw=_dummy_hw(), measure="wallclock",
                             device=device)
    return unit_time_stats(an, batch, seq, "decode", iters)


def _dummy_hw() -> HardwareModel:
    from repro_torch.core.hardware import H100
    return H100
