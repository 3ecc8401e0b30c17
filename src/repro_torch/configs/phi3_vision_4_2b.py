"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend STUBBED: the batch's
``"patches"`` are precomputed patch embeddings (B, num_patches, d_model)
prepended to the token sequence.  [hf:microsoft/Phi-3-vision-128k-instruct]

The same configuration as ``repro.configs.phi3_vision_4_2b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        act="silu", gated_mlp=True,
        attn_pattern=("global",), rope_theta=10000.0,
        frontend="vision_stub", num_patches=144,
        tie_embeddings=False,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, num_patches=8, dtype="float32",
        remat="none", loss_chunk=0, fsdp=False)
