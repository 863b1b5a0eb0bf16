"""deepseek-v2-lite [moe]: 27L d2048 16H MLA without a query latent
(kv_lora 512, nope 128 + rope 64, v 128), YaRN rope (factor 40 over 4096
positions), one leading dense SwiGLU (d_ff 10944), then 26 MoE layers of
64 routed experts (width 1408) top-6, softmax weights not renormalised, and
2 shared experts; vocab 102400, untied.  15,706,484,224 parameters.
[hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434]"""
from repro_torch.models.common import LayerSpec, ModelConfig, MLA, DENSE, MOE


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        vocab=102400,
        # first_k_dense_replace 1: one period of 27 positions
        layout=(LayerSpec(MLA, DENSE),) + (LayerSpec(MLA, MOE),) * 26,
        rope_theta=10000.0,
        q_lora_rank=0,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        mla_rope_freqs="rope",
        yarn_factor=40.0,
        yarn_original_max_pos=4096,
        yarn_mscale_all_dim=0.707,
        moe_experts=64,
        moe_topk=6,
        moe_dff=1408,
        moe_renormalize=False,
        moe_shared_experts=2,
        norm_eps=1e-6,
        tie_embeddings=False,
    )
