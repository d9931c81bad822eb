"""paligemma-3b [vlm]: gemma backbone (18L d_model=2048 8H kv=1 d_ff=16384)
vocab=257216 with SigLIP vision frontend (stubbed: input_specs() yields 256
patch embeddings). [arXiv:2407.07726; hf]."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="vision", num_positions=256),
    source="arXiv:2407.07726; hf",
)
