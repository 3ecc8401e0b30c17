"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096).
DyDD expert balancing ON (the paper-representative MoE cell).
[arXiv:2401.04088; hf]

The same configuration as ``repro.configs.mixtral_8x22b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=32768,
        act="silu", gated_mlp=True,
        attn_pattern=("local",), window=4096, rope_theta=1000000.0,
        num_experts=8, experts_per_token=2, capacity_factor=1.25,
        moe_dydd_balance=True, moe_ep=True, moe_virtual_experts=2,
        tie_embeddings=False,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512, train_accum=8,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=512, window=32, num_experts=4,
        experts_per_token=2, dtype="float32", remat="none", loss_chunk=0,
        fsdp=False)
