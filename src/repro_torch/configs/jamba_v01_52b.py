"""jamba-v0.1-52b [hybrid]: 32L d4096, mamba:attention 1:7 interleave,
attention 32H (kv8, hd128), MoE 16e top-2 every other layer, d_ff 14336,
vocab 65536. Period-8 block: attention at position 3, MoE at odd positions.
[arXiv:2403.19887; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, MAMBA, DENSE, MOE


def config() -> ModelConfig:
    layout = tuple(
        LayerSpec(
            FULL if i == 3 else MAMBA,
            MOE if i % 2 == 1 else DENSE,
        )
        for i in range(8)
    )
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65536,
        layout=layout,
        moe_experts=16,
        moe_topk=2,
        moe_dff=14336,
        ssm_d_state=16,
        ssm_d_conv=4,
        ssm_expand=2,
        pos="none",  # jamba uses no positional encoding (mamba provides order)
        tie_embeddings=False,
    )
