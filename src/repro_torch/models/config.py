"""Model configuration shared by all assigned architectures.

A copy of ``repro.models.config`` (pure Python), so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single flexible decoder / encoder-decoder LM configuration.

    ``attn_pattern`` is cycled over layers; entries:
      "global" — full (causal) attention,
      "local"  — sliding-window attention (``window``),
      "rglru"  — RG-LRU recurrent block (recurrentgemma),
      "ssd"    — Mamba-2 state-space duality block.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Activation / MLP.
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True           # SwiGLU / GeGLU when True

    # Attention pattern.
    attn_pattern: tuple = ("global",)
    window: int = 4096
    rope_theta: float = 10000.0
    logits_softcap: float = 0.0
    attn_softcap: float = 0.0
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) scaling

    # Mixture of Experts.
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_dydd_balance: bool = True    # paper's technique as expert balancer
    moe_ep: bool = False             # expert parallelism (experts sharded
                                     # over 'model'); else d_ff TP
    moe_virtual_experts: int = 1     # split each expert into v half-width
                                     # shards so E*v divides the model axis
                                     # (mixtral: 8 experts x 2 = 16)

    # SSM (mamba2).
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # RG-LRU (recurrentgemma).
    lru_width: int = 0

    # Encoder-decoder (whisper) / modality stubs.
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed frame count (whisper: 1500)
    frontend: str = "none"           # none | audio_stub | vision_stub
    num_patches: int = 0             # vlm stub patch count

    # Norms / embeddings.
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # Parallelism / memory hints (consumed by runtime/).
    fsdp: bool = True
    remat: str = "block"             # none | block | group
    remat_group: int = 8             # layers-per-residual for remat="group"
    dtype: str = "bfloat16"
    loss_chunk: int = 0              # sequence-chunked loss (0 = off)
    train_accum: int = 1             # gradient-accumulation microbatches
    attn_q_chunk: int = 0            # blocked attention q-chunk (0 = full)
    scan_layers: bool = True         # False: unroll (dry-run cost analysis)
    sharding_profile: str = "tp"     # "tp" (FSDP+TP) | "dp" (pure DP+FSDP)

    def layer_type(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return all(t in ("rglru", "ssd") for t in self.attn_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer keeps an unbounded full-length KV cache."""
        return all(t != "global" for t in self.attn_pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy (smoke tests)."""
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (used for roofline MODEL_FLOPS) -------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = 0
        layers = self.num_layers

        def attn_params():
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def mlp_params(ff):
            return d * ff * (3 if self.gated_mlp else 2)

        for i in range(layers):
            t = self.layer_type(i)
            if t in ("global", "local"):
                n += attn_params()
            elif t == "rglru":
                w = self.lru_width or d
                # in/out proj (x and gate branches) + gates + conv-ish mixing
                n += 2 * d * w + w * d + 3 * w
            elif t == "ssd":
                di = self.ssm_expand * d
                ng, st = self.ssm_ngroups, self.ssm_state
                n += d * (2 * di + 2 * ng * st + di // self.ssm_headdim)
                n += di * d + self.ssm_conv * (di + 2 * ng * st)
            if self.num_experts > 0:
                e = self.num_experts
                k = self.experts_per_token
                per = mlp_params(f)
                n += d * e + (k if active_only else e) * per
            elif f > 0:
                n += mlp_params(f)
            n += 2 * d  # norms
        if self.is_encoder_decoder:
            # encoder blocks (global attn + mlp) + cross-attn in decoder
            n += self.encoder_layers * (attn_params() + mlp_params(f) + 2 * d)
            n += layers * attn_params()  # cross attention
        n += v * d  # embeddings (tied head)
        if not self.tie_embeddings:
            n += v * d
        return n
