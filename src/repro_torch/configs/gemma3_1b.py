"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global attention (window 512), 128k context, GeGLU, head_dim=256,
dual rope theta (10k local / 1M global).  [hf:google/gemma-3-1b-pt]

The same configuration as ``repro.configs.gemma3_1b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262144,
        act="gelu", gated_mlp=True,
        attn_pattern=("local", "local", "local", "local", "local",
                      "global"),
        window=512, rope_theta=1000000.0,
        scale_embeddings=True, tie_embeddings=True,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512, sharding_profile="dp",
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=6, d_model=48, num_heads=4, num_kv_heads=1, head_dim=12,
        d_ff=96, vocab_size=512, window=16, dtype="float32", remat="none",
        loss_chunk=0, fsdp=False)
