"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

12L encoder + 12L decoder, d_model=1024, 16H (kv=16), d_ff=4096, vocab=256206.
[arXiv:2308.11596; hf]. The speech frontend (w2v-BERT conformer) is a stub:
input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    act="relu",
    gated_mlp=False,
    norm="layernorm",
    frontend=FrontendConfig(kind="audio", num_positions=1024),
    source="arXiv:2308.11596; hf",
)
