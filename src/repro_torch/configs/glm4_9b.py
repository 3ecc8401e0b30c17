"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE, GQA, SwiGLU.  [hf:THUDM/glm-4-9b]

The same configuration as ``repro.configs.glm4_9b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        head_dim=128, d_ff=13696, vocab_size=151552,
        act="silu", gated_mlp=True,
        attn_pattern=("global",), rope_theta=10000.0,
        tie_embeddings=False,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=192, vocab_size=512, dtype="float32", remat="none",
        loss_chunk=0, fsdp=False)
