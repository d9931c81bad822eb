"""Model facade (port of ``repro.models.model``): build_model(cfg) -> Model
with init / init_cache / encode / forward / loss_fn / prefill / decode_step.

The dense ``prefill``/``decode_step`` pair is the oracle the paged engine
path is held against; ``core.memory_manager`` re-groups the same parameter
tree by the offload plan while the math here stays unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import virtual_kv_heads

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    tp: int = 1  # model-axis size the KV replication targets

    # ---- specs ------------------------------------------------------------
    @functools.cached_property
    def spec(self) -> Params:
        return T.model_spec(self.cfg)

    @property
    def virtual_kv(self) -> int:
        return virtual_kv_heads(self.cfg, self.tp)

    def cache_spec(self, batch: int, cache_len: int, enc_len: int = 0):
        return T.cache_spec(self.cfg, batch, cache_len, self.virtual_kv,
                            enc_len)

    # ---- materialization ----------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str) -> Params:
        return S.initialize(self.spec, generator, device)

    def init_cache(self, generator: torch.Generator,
                   device: torch.device | str, batch: int, cache_len: int,
                   enc_len: int = 0) -> Any:
        return S.initialize(self.cache_spec(batch, cache_len, enc_len),
                            generator, device)

    # ---- encoder ------------------------------------------------------------
    def encode(self, params: Params, enc_embeds: torch.Tensor,
               attn_impl: str = "flash"):
        """Encoder forward (seamless). enc_embeds: [B, S_enc, D].
        Returns (normed encoder output, encoder positions [B, S_enc])."""
        cfg = self.cfg
        b, s, _ = enc_embeds.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=enc_embeds.device).expand(b, s)
        ctx = T.SeqCtx(positions=pos, virtual_kv=self.virtual_kv,
                       attn_impl=attn_impl)
        enc = params["encoder"]
        x, _, _ = T.apply_stack_seq(cfg, enc["blocks"],
                                    enc_embeds.to(torch.bfloat16), ctx,
                                    pattern=(T.ENCODER_BLOCK,))
        return L.apply_norm(cfg, enc["final_norm"], x), pos

    def embed_inputs(self, params: Params, inputs: dict) -> torch.Tensor:
        """Token embeddings, after the frontend's patch embeddings for a
        vision model: [B, S_f + S_tok, D]."""
        cfg = self.cfg
        x = T.embed_tokens(cfg, params, inputs["tokens"])
        if cfg.frontend is not None and cfg.family != "audio":
            fe = inputs["frontend_embeds"].to(x.dtype)
            x = torch.cat([fe, x], dim=1)
        return x

    # ---- full-sequence forward ----------------------------------------------
    def forward(self, params: Params, inputs: dict, *, want_cache: bool = False,
                cache_len: int = 0, attn_impl: str = "flash",
                remat: bool = False):
        """Returns (hidden [B,S,D], caches_or_None, aux, enc_pos_or_None).

        inputs: {"tokens": [B,S_tok]} (+"frontend_embeds" [B,S_f,D] for vlm,
        +"enc_embeds" [B,S_enc,D] for enc-dec audio)."""
        cfg = self.cfg
        enc_out = enc_pos = None
        if cfg.encoder_layers > 0:
            enc_out, enc_pos = self.encode(params, inputs["enc_embeds"],
                                           attn_impl)
        x = self.embed_inputs(params, inputs)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device).expand(b, s)
        ctx = T.SeqCtx(positions=pos, want_cache=want_cache,
                       cache_len=cache_len or s, virtual_kv=self.virtual_kv,
                       enc_out=enc_out, enc_pos=enc_pos, attn_impl=attn_impl)
        x, caches, aux = T.apply_stack_seq(cfg, params["blocks"], x, ctx,
                                           remat=remat)
        x = L.apply_norm(cfg, params["final_norm"], x)
        return x, caches, aux, enc_pos

    # ---- losses ---------------------------------------------------------------
    def loss_fn(self, params: Params, batch: dict, *, remat: bool = True,
                attn_impl: str = "flash"):
        """batch: {"tokens" [B,S], "labels" [B,S], (+frontend/enc inputs)}.
        Returns (xent + 0.01 * aux, {"xent", "aux"}). The loss is taken over
        the token positions only (a VLM's patch positions are sliced off)."""
        cfg = self.cfg
        hidden, _, aux, _ = self.forward(params, batch, attn_impl=attn_impl,
                                         remat=remat)
        if cfg.frontend is not None and cfg.family != "audio":
            hidden = hidden[:, batch["frontend_embeds"].shape[1]:]
        logits = T.lm_logits(cfg, params, hidden)
        loss = T.xent_loss(cfg, logits, batch["labels"])
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    # ---- serving steps ---------------------------------------------------------
    def prefill(self, params: Params, inputs: dict, cache_len: int,
                attn_impl: str = "flash", last_pos: int | None = None):
        """Returns (last-token logits [B,V], caches, enc_pos).

        ``last_pos`` selects the logits position for shape-bucketed prefills
        whose token rows carry causally-inert suffix padding (default: the
        final row, i.e. unpadded inputs)."""
        hidden, caches, _, enc_pos = self.forward(
            params, inputs, want_cache=True, cache_len=cache_len,
            attn_impl=attn_impl)
        h = hidden[:, -1:] if last_pos is None else \
            hidden[:, last_pos:last_pos + 1]
        logits = T.lm_logits(self.cfg, params, h)[:, 0]
        return logits, caches, enc_pos

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    pos: torch.Tensor, caches: Any,
                    enc_pos: torch.Tensor | None = None):
        """One token for every row. tokens/pos: [B]. Returns (logits, caches)."""
        cfg = self.cfg
        x = T.embed_tokens(cfg, params, tokens[:, None])
        x, new_caches = T.apply_stack_decode(
            cfg, params["blocks"], x, pos, caches, self.virtual_kv, enc_pos)
        x = L.apply_norm(cfg, params["final_norm"], x)
        logits = T.lm_logits(cfg, params, x)[:, 0]
        return logits, new_caches


def build_model(cfg: ModelConfig, tp: int = 1) -> Model:
    return Model(cfg=cfg, tp=tp)
