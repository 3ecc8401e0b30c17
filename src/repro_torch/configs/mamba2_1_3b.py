"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality), expand=2, headdim=64.
[arXiv:2405.21060]

The same configuration as ``repro.configs.mamba2_1_3b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=50280,
        attn_pattern=("ssd",),
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
        ssm_ngroups=1, ssm_chunk=256,
        tie_embeddings=True,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=3, d_model=64, vocab_size=512, ssm_state=16,
        ssm_headdim=16, ssm_chunk=8, dtype="float32", remat="none",
        loss_chunk=0, fsdp=False)
