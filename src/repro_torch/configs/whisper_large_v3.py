"""whisper-large-v3 [audio]: enc-dec, 32L each, d_model=1280 20H (MHA)
d_ff=5120 vocab=51866 — conv frontend STUBBED: the batch's ``"frames"``
are precomputed frame embeddings (B, 1500, 1280).  GELU (non-gated),
LayerNorm, learned positions.  [arXiv:2212.04356]

The same configuration as ``repro.configs.whisper_large_v3``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        head_dim=64, d_ff=5120, vocab_size=51866,
        act="gelu", gated_mlp=False,
        attn_pattern=("global",), rope_theta=0.0,
        is_encoder_decoder=True, encoder_layers=32, encoder_seq=1500,
        frontend="audio_stub",
        tie_embeddings=True, norm="layernorm",
        fsdp=True, remat="block", dtype="bfloat16", loss_chunk=512,
        attn_q_chunk=512, sharding_profile="dp",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_seq=24, dtype="float32", remat="none", loss_chunk=0,
        fsdp=False)
