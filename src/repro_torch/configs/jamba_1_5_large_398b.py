"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave (attention at
position 4 of every 8-block period), MoE on every other block.
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import BlockSpec, MambaConfig, ModelConfig, MoEConfig


def _period8() -> tuple[BlockSpec, ...]:
    blocks = []
    for j in range(8):
        mixer = "attention" if j == 4 else "mamba"
        mlp = "moe" if j % 2 == 1 else "dense"
        blocks.append(BlockSpec(mixer=mixer, mlp=mlp))
    return tuple(blocks)


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_period8(),
    moe=MoEConfig(num_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    param_fsdp=True,
    source="arXiv:2403.19887; hf",
)
