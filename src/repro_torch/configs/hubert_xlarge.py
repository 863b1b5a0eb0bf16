"""hubert-xlarge [audio]: 48L encoder d1280 16H (hd80) dense-gelu d_ff 5120,
vocab 504 (cluster targets). Conv waveform frontend is a STUB: inputs are
precomputed frame embeddings. [arXiv:2106.07447; unverified]"""
from repro_torch.models.common import LayerSpec, ModelConfig, FULL, DENSE


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab=504,
        layout=(LayerSpec(FULL, DENSE),),
        causal=False,
        activation="gelu",
        pos="rope",  # conv-positional frontend stubbed; rope stands in
        tie_embeddings=False,
        modality="audio_stub",
    )
