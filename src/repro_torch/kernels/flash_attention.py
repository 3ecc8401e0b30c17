"""Causal / sliding-window flash attention on the card.

Wrapper of the CUDA kernels in ``csrc/flash_attention.cu`` (the Hopper
counterpart of the TPU kernel ``repro.kernels.flash_attention``): online
softmax attention over q, k, v of shape (BH, S, D) with the heads folded
into the batch and the kv heads already expanded, f32 accumulation, the
output in the input type.  bf16 runs on the tensor cores (``mma.sync``),
f32 in exact f32 arithmetic.  It takes CUDA tensors only;
:func:`repro_torch.kernels.ops.flash_attention` routes CPU tensors to the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches since the last reset (see ops.reset_counts)

_FN = {torch.float32: "repro_flash_attention_f32",
       torch.bfloat16: "repro_flash_attention_bf16"}
MAX_HEAD_DIM = 256
MAX_BH = 65535   # the grid's y extent


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, S, D); ``window <= 0`` is unbounded."""
    global launches
    dtype = _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v},
                                dtypes=_build.LM_DTYPES)
    if q.dim() != 3 or min(q.shape) < 1:
        raise ValueError(f"flash_attention: q must be (BH, S, D) with "
                         f"BH, S, D >= 1 (got {tuple(q.shape)})")
    bh, s, d = q.shape
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: D must be a multiple of 8 and "
                         f"at most {MAX_HEAD_DIM} (got {d})")
    if bh > MAX_BH:
        raise ValueError(f"flash_attention: BH must be at most {MAX_BH} "
                         f"(got {bh})")
    for key, t in (("k", k), ("v", v)):
        _build.check_shape("flash_attention", key, t, (bh, s, d))
    _build.check_aligned("flash_attention", {"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lib = _build.load()
    err = getattr(lib, _FN[dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
