"""Input-shape registry: the 4 assigned shapes x 10 archs = 40 cells.

The counterpart of ``repro.configs.shapes``:

  train_4k     seq 4096,   global_batch 256   -> train step
  prefill_32k  seq 32768,  global_batch 32    -> prefill step
  decode_32k   seq 32768,  global_batch 128   -> serve step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524288, global_batch 1     -> serve step; run only for
                                                 sub-quadratic-cache archs

:func:`input_specs` and :func:`decode_cache_specs` give ``meta``-device
tensors (shapes and dtypes, no memory) of every input of an (arch,
shape) cell, as the reference's ``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}

# Pure full-attention archs skip long_500k (unbounded KV cache).  whisper
# skips it because the enc-dec family has no 500k decode state (decoder
# context <= 448 architecturally).
LONG_CONTEXT_OK = {
    "recurrentgemma-9b", "mamba2-1.3b", "mixtral-8x22b", "gemma3-1b",
}


def cell_supported(cfg: ModelConfig, shape: str) -> tuple:
    """(supported, reason)."""
    if shape == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, ("pure full-attention (or bounded enc-dec) arch: "
                       "unbounded 500k KV cache excluded per DESIGN.md §5")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def shape_case(shape) -> ShapeCase:
    """``shape``'s :class:`ShapeCase`: a name of :data:`SHAPES`, or a case
    itself (a cell at other sizes)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ModelConfig, shape) -> dict:
    """``meta`` stand-ins for every input of this (arch, shape) (a name of
    :data:`SHAPES` or a :class:`ShapeCase`):

    train   -> {"tokens", "labels", "mask"} (+ modality stubs)
    prefill -> {"tokens"} (+ modality stubs)
    decode  -> {"tokens" (B, 1)}; the cache comes from
               :func:`decode_cache_specs`.
    """
    from repro_torch.models.transformer import DTYPES

    case = shape_case(shape)
    B, S = case.global_batch, case.seq_len
    dt = DTYPES[cfg.dtype]
    extras = {}
    if cfg.frontend == "audio_stub":
        extras["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.frontend == "vision_stub" and case.kind != "decode":
        extras["patches"] = _meta((B, cfg.num_patches, cfg.d_model), dt)
    if case.kind == "train":
        return {"tokens": _meta((B, S), torch.int32),
                "labels": _meta((B, S), torch.int32),
                "mask": _meta((B, S), torch.float32), **extras}
    if case.kind == "prefill":
        return {"tokens": _meta((B, S), torch.int32), **extras}
    return {"tokens": _meta((B, 1), torch.int32), **extras}


def decode_cache_specs(cfg: ModelConfig, shape):
    """The decode cache of this cell (a name of :data:`SHAPES` or a
    :class:`ShapeCase`) as ``meta`` tensors."""
    from repro_torch.models import transformer

    case = shape_case(shape)
    return transformer.init_decode_cache(cfg, case.global_batch,
                                         case.seq_len, device=META)
