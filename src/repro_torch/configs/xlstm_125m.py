"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (blocks contain their own projections; no separate MLP).
[arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(BlockSpec(mixer="mlstm", mlp="dense"),
             BlockSpec(mixer="slstm", mlp="dense")),
    xlstm=XLSTMConfig(),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
