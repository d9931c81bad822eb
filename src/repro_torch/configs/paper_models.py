"""The paper's own evaluation models (§5.1): OPT-6.7B, OPT-13B, Qwen2-beta-7B,
LLaMA2-13B. Used by the benchmark reproductions (fig2..fig14).

Note: OPT uses learned positional embeddings and ReLU; we keep RoPE for
positional encoding (systems behaviour — layer structure, sizes, per-layer
bytes/FLOPs — is what the reproduction depends on; recorded in DESIGN.md §9).
"""
from repro_torch.configs.base import ModelConfig

OPT_6_7B = ModelConfig(
    name="opt-6.7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=16384, vocab_size=50272,
    act="relu", gated_mlp=False, norm="layernorm",
    source="arXiv:2205.01068; hf",
)

OPT_13B = ModelConfig(
    name="opt-13b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=40, d_ff=20480, vocab_size=50272,
    act="relu", gated_mlp=False, norm="layernorm",
    source="arXiv:2205.01068; hf",
)

QWEN2_BETA_7B = ModelConfig(
    name="qwen2-beta-7b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=151936,
    qkv_bias=True, source="hf:Qwen/Qwen1.5-7B; hf",
)

LLAMA2_13B = ModelConfig(
    name="llama2-13b", family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=40, d_ff=13824, vocab_size=32000,
    source="arXiv:2307.09288; hf",
)
