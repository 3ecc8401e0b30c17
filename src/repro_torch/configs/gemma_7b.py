"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU MLP, head_dim=256, full global attention, gemma-style embedding
scaling.  [arXiv:2403.08295; hf]

The same configuration as ``repro.configs.gemma_7b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        act="gelu", gated_mlp=True,
        attn_pattern=("global",), rope_theta=10000.0,
        scale_embeddings=True, tie_embeddings=True,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", remat="none",
        loss_chunk=0, fsdp=False)
