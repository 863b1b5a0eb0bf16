"""falcon-mamba-7b [ssm]: 64L d4096 attn-free mamba1, vocab 65024, d_state 16.
[arXiv:2410.05355; unverified]"""
from repro_torch.models.common import LayerSpec, ModelConfig, MAMBA, NONE


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab=65024,
        layout=(LayerSpec(MAMBA, NONE),),
        ssm_d_state=16,
        ssm_d_conv=4,
        ssm_expand=2,
        pos="none",
        tie_embeddings=True,
    )
