"""gemma-2b [dense]: 18L d2048 8H MQA (kv1, hd256) geglu d_ff 16384,
vocab 256000, embedding scaling. [arXiv:2403.08295; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        layout=(LayerSpec(FULL, DENSE),),
        activation="geglu",
        emb_scale=True,
        tie_embeddings=True,
    )
