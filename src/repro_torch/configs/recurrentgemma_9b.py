"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, pattern (R, R, A) (2 recurrent per
1 attention), window 2048, lru_width=4096.  [arXiv:2402.19427]

The same configuration as ``repro.configs.recurrentgemma_9b``.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        act="gelu", gated_mlp=True,
        attn_pattern=("rglru", "rglru", "local"),
        window=2048, rope_theta=10000.0, lru_width=4096,
        scale_embeddings=True, tie_embeddings=True,
        norm="rmsnorm", fsdp=True, remat="block", dtype="bfloat16",
        loss_chunk=512, attn_q_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, window=16, lru_width=64,
        dtype="float32", remat="none", loss_chunk=0, fsdp=False)
