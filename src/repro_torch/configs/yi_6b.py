"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama-architecture with GQA, SwiGLU.  [arXiv:2403.04652; hf]

The same configuration as ``repro.configs.yi_6b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=11008, vocab_size=64000,
        act="silu", gated_mlp=True,
        attn_pattern=("global",), rope_theta=5000000.0,
        tie_embeddings=False,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512, dtype="float32", remat="none",
        loss_chunk=0, fsdp=False)
