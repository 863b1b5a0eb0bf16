"""granite-moe-1b-a400m [moe]: 24L d1024 16H (kv8) MoE 32e top-8, d_ff 512/exp.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, MOE


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab=49155,
        layout=(LayerSpec(FULL, MOE),),
        moe_experts=32,
        moe_topk=8,
        moe_dff=512,
        tie_embeddings=True,
    )
