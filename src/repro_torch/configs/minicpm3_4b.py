"""minicpm3-4b [dense]: 62L d2560 40H MLA (q_lora 768, kv_lora 256,
nope 64 + rope 32, v 64), d_ff 6400, vocab 73448. [hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, MLA, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab=73448,
        layout=(LayerSpec(MLA, DENSE),),
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        tie_embeddings=True,
    )
