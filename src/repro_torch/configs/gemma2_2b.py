"""gemma2-2b [dense]: 26L d2304 8H (kv4, hd256) geglu d_ff 9216, vocab 256000;
alternating local(4096)/global attention, attn softcap 50, logit softcap 30,
sandwich norms, embedding scaling. [arXiv:2408.00118; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, SWA, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        layout=(LayerSpec(SWA, DENSE), LayerSpec(FULL, DENSE)),
        window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        activation="geglu",
        emb_scale=True,
        sandwich_norm=True,
        tie_embeddings=True,
    )
