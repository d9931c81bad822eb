"""Modality frontend stubs (port of ``repro.models.frontends``).

The [audio]/[vlm] entries specify the transformer backbone only; the
frontend (w2v-BERT conformer for seamless, SigLIP ViT for paligemma) is a
stub: the caller provides precomputed frame/patch embeddings with the
documented output shape. These helpers centralize those shapes and draw
stub embeddings for smoke runs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def frontend_positions(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Number of frontend embedding positions for a given shape cell."""
    if cfg.frontend is None:
        return 0
    if cfg.family == "audio":
        # Encoder consumes frames; frontend fills the whole encoder input.
        return encoder_len(cfg, shape)
    # Vision: fixed patch grid (e.g. SigLIP 224px/14 -> 256 patches).
    return cfg.frontend.num_positions


def encoder_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Encoder source length for enc-dec cells."""
    if cfg.encoder_layers == 0:
        return 0
    if shape.step == "decode":
        # Decode cells measure decoder-side TPOT; a moderate, fixed source.
        return min(shape.seq_len, 4096)
    return shape.seq_len


def stub_embeddings(cfg: ModelConfig, batch: int, positions: int,
                    generator: torch.Generator,
                    device: torch.device | str) -> torch.Tensor:
    """Random embeddings standing in for the frontend output: N(0, 1) in
    float32 from ``generator``, cast to bf16, times 0.02 (the reference's
    recipe; its bits differ, so tests feed both sides the same arrays)."""
    dim = (cfg.frontend.embed_dim or cfg.d_model) if cfg.frontend else cfg.d_model
    x = torch.randn((batch, positions, dim), generator=generator,
                    dtype=torch.float32, device=device)
    return x.to(torch.bfloat16) * 0.02
