"""h2o-danube-3-4b [dense]: 24L d3840 32H (kv8, hd120) d_ff 10240 silu,
vocab 32000, llama+mistral mix with sliding-window attention on all layers.
[arXiv:2401.16818; unverified]"""
from repro_torch.models.common import LayerSpec, ModelConfig, SWA, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab=32000,
        layout=(LayerSpec(SWA, DENSE),),
        window=4096,
        tie_embeddings=False,
    )
