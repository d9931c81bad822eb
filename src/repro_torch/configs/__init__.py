"""Config registry: ``get_config(name)`` / ``ASSIGNED_ARCHS`` / shapes."""
from __future__ import annotations

from repro_torch.configs.base import (
    LM_SHAPES,
    BlockSpec,
    FrontendConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    XLSTMConfig,
    cell_is_runnable,
)
from repro_torch.configs import paper_models as _paper

from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25
from repro_torch.configs.h2o_danube3_4b import CONFIG as _danube
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

# The 10 assigned pool architectures, in the assignment's order.
ASSIGNED_ARCHS: tuple[str, ...] = (
    "seamless-m4t-medium",
    "grok-1-314b",
    "dbrx-132b",
    "gemma-2b",
    "qwen2.5-3b",
    "h2o-danube-3-4b",
    "deepseek-7b",
    "paligemma-3b",
    "jamba-1.5-large-398b",
    "xlstm-125m",
)

PAPER_MODELS: tuple[str, ...] = (
    "opt-6.7b", "opt-13b", "qwen2-beta-7b", "llama2-13b",
)

_REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _seamless, _grok, _dbrx, _gemma, _qwen25, _danube, _deepseek,
        _paligemma, _jamba, _xlstm,
        _paper.OPT_6_7B, _paper.OPT_13B, _paper.QWEN2_BETA_7B, _paper.LLAMA2_13B,
    )
}


def get_config(name: str) -> ModelConfig:
    key = name.strip().lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeSpec:
    if name not in LM_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(LM_SHAPES)}")
    return LM_SHAPES[name]


def all_cells(include_paper_models: bool = False):
    """Yield every runnable (config, shape) cell."""
    names = ASSIGNED_ARCHS + (PAPER_MODELS if include_paper_models else ())
    for arch in names:
        cfg = get_config(arch)
        for shape in LM_SHAPES.values():
            ok, _why = cell_is_runnable(cfg, shape)
            if ok:
                yield cfg, shape


__all__ = [
    "ASSIGNED_ARCHS", "PAPER_MODELS", "LM_SHAPES",
    "ModelConfig", "ShapeSpec", "BlockSpec", "MoEConfig", "MambaConfig",
    "XLSTMConfig", "FrontendConfig",
    "get_config", "get_shape", "list_configs", "all_cells", "cell_is_runnable",
]
