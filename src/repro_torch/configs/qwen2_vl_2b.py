"""qwen2-vl-2b [vlm]: 28L d1536 12H (kv2, hd128) d_ff 8960 silu,
vocab 151936, M-RoPE (sections 16/24/24), dynamic-resolution vision
frontend STUBBED (precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab=151936,
        layout=(LayerSpec(FULL, DENSE),),
        pos="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1e6,
        tie_embeddings=True,
        modality="vision_stub",
    )
