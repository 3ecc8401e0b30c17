"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  The 64-expert ring gives DyDD its richest processor
graph among the assigned archs.  [arXiv:2409.02060; hf]

The same configuration as ``repro.configs.olmoe_1b_7b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1024, vocab_size=50304,
        act="silu", gated_mlp=True,
        attn_pattern=("global",), rope_theta=10000.0,
        num_experts=64, experts_per_token=8, capacity_factor=1.25,
        moe_dydd_balance=True, moe_ep=True,
        tie_embeddings=False,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, num_experts=8, experts_per_token=2,
        dtype="float32", remat="none", loss_chunk=0, fsdp=False)
