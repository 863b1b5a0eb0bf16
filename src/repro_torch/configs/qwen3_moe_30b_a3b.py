"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (kv4, hd128) MoE 128e top-8, 768/exp.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, MOE


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab=151936,
        layout=(LayerSpec(FULL, MOE),),
        moe_experts=128,
        moe_topk=8,
        moe_dff=768,
        rope_theta=1e6,
        tie_embeddings=False,
    )
