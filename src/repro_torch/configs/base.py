"""Model/shape configuration system.

Every architecture in the assigned pool (plus the paper's own eval models) is a
``ModelConfig``. Shapes (``train_4k`` etc.) are ``ShapeSpec``s. A *cell* is a
(ModelConfig, ShapeSpec) pair; ``launch/dryrun.py`` iterates cells.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

# ---------------------------------------------------------------------------
# Block kinds composing a layer stack. A stack is described by a repeating
# *pattern* of BlockSpecs; homogeneous models have a single-entry pattern.
# ---------------------------------------------------------------------------

MixerKind = Literal["attention", "mamba", "slstm", "mlstm"]
MlpKind = Literal["dense", "moe"]
ActKind = Literal["silu", "gelu", "relu"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One decoder block: a sequence mixer + an MLP (possibly MoE)."""

    mixer: MixerKind = "attention"
    mlp: MlpKind = "dense"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # Dense-dispatch capacity factor (MaxText-style "dropping" MoE).
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2  # inner dim = expand * d_model


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # mLSTM: matrix-memory heads; sLSTM: scalar-memory recurrent heads.
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    conv1d_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: input_specs() yields precomputed embeddings."""

    kind: Literal["audio", "vision"] = "vision"
    # Number of frontend embedding positions prepended / consumed.
    num_positions: int = 256
    embed_dim: int = 0  # 0 => d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    act: ActKind = "silu"
    gated_mlp: bool = True  # SwiGLU/GeGLU style (w1, w3 gate, w2 down)
    qkv_bias: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    # Sliding-window attention; 0 = full attention.
    sliding_window: int = 0
    tie_embeddings: bool = False
    # Repeating block pattern; cycled to num_layers. Default: [attention+dense].
    pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    # Encoder-decoder (seamless): encoder layer count; 0 = decoder-only.
    encoder_layers: int = 0
    frontend: FrontendConfig | None = None
    # Giant models (>~100B) store params sharded over the data axis too (FSDP).
    param_fsdp: bool = False
    dtype: str = "bfloat16"
    # Reference citation tier, carried for documentation.
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def blocks(self) -> tuple[BlockSpec, ...]:
        reps = math.ceil(self.num_layers / len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])

    @property
    def is_subquadratic(self) -> bool:
        """True if long_500k decode is runnable (SSM/hybrid/SWA)."""
        if self.sliding_window > 0:
            return True
        return any(b.mixer != "attention" for b in self.pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (seamless is enc-dec)

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def num_params(self) -> int:
        """Analytic parameter count (embedding + stacks), for roofline MODEL_FLOPS."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab() * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab() * d  # lm head
        for blk in self.blocks:
            n += self._mixer_params(blk.mixer, d, hd)
            n += self._mlp_params(blk.mlp, d)
            n += 2 * d  # two norms
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                n += self._mixer_params("attention", d, hd)
                n += self._mlp_params("dense", d)
                n += 2 * d
            # cross attention in each decoder block
            n += self.num_layers * self._mixer_params("attention", d, hd)
        return n

    def num_active_params(self) -> int:
        """Params touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.num_params()
        d = self.d_model
        full = self.num_params()
        moe_blocks = sum(1 for b in self.blocks if b.mlp == "moe")
        per_expert = self._mlp_params("dense", d)
        inactive = moe_blocks * (self.moe.num_experts - self.moe.top_k) * per_expert
        return full - inactive

    def _mixer_params(self, mixer: MixerKind, d: int, hd: int) -> int:
        if mixer == "attention":
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b
        if mixer == "mamba":
            mc = self.mamba or MambaConfig()
            di = mc.expand * d
            return (d * 2 * di          # in_proj (x, z)
                    + di * mc.d_conv     # conv1d
                    + di * (mc.d_state * 2 + 1)  # B, C, dt projections (selective)
                    + di * mc.d_state    # A
                    + di                 # D
                    + di * d)            # out_proj
        if mixer in ("slstm", "mlstm"):
            xc = self.xlstm or XLSTMConfig()
            pf = xc.proj_factor_mlstm if mixer == "mlstm" else 1.0
            di = int(pf * d)
            if mixer == "mlstm":
                # up-proj, q/k/v projections, gates, out-proj
                return d * 2 * di + 3 * di * di // max(self.num_heads, 1) + 2 * di + di * d
            # sLSTM: 4 gates recurrent + input
            return 4 * (d * d + d * d // max(self.num_heads, 1)) + 4 * d
        raise ValueError(mixer)

    def _mlp_params(self, mlp: MlpKind, d: int) -> int:
        if self.d_ff == 0:
            return 0
        per = d * self.d_ff * (3 if self.gated_mlp else 2)
        if mlp == "moe":
            assert self.moe is not None
            return self.moe.num_experts * per + d * self.moe.num_experts  # + router
        return per


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

StepKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: StepKind

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


LM_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell per the assignment rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
