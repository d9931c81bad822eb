"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import BlockSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    pattern=(BlockSpec(mixer="attention", mlp="moe"),),
    moe=MoEConfig(num_experts=16, top_k=4),
    param_fsdp=True,
    source="hf:databricks/dbrx-base; unverified",
)
