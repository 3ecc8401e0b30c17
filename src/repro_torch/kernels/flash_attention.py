"""Causal / sliding-window flash attention on the card.

Wrapper of the CUDA kernels in ``csrc/flash_attention.cu`` (the Hopper
counterpart of the TPU kernel ``repro.kernels.flash_attention``): online
softmax attention over q of shape (BH, S, D) with the heads folded into
the batch, and k, v of shape (BH_kv, S, D) with BH_kv dividing BH: row
``bh // (BH // BH_kv)`` of k and v serves query row ``bh``
(``repeat_interleave``'s order), so an MQA or GQA layer's kv heads are
read in place.  f32 accumulation, the output in the input type.  bf16
runs on the tensor cores (``wgmma`` fed by TMA, three warpgroups a CTA),
f32 in exact f32 arithmetic.  It takes CUDA tensors only;
:func:`repro_torch.kernels.ops.flash_attention` routes CPU tensors to the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_shapes

launches = 0   # kernel launches since the last reset (see ops.reset_counts)

_FN = {torch.float32: "repro_flash_attention_f32",
       torch.bfloat16: "repro_flash_attention_bf16"}
MAX_HEAD_DIM = 256
MAX_BH = 65535     # the f32 grid's y extent
MAX_SMEM = 232448  # dynamic shared memory a CTA may use on an H100
BOX_BYTES = 64 * 128   # one TMA box of the bf16 kernel: 64 rows of 64 bf16


def launch_plan(q_shape, k_shape, v_shape, dtype: torch.dtype) -> dict:
    """Shape checks and the launch of one call: the head dimension DP the
    kernel is compiled for, the q rows a CTA owns (BQ), the kv rows a tile
    holds (BK), the ring's stages, the dynamic shared memory in bytes,
    threads a CTA and CTAs.  The tiles are ``Bf16Cfg`` and
    ``f32_smem_bytes`` of the source, which asserts the same 227 KB limit
    when it compiles."""
    rep = attention_shapes("flash_attention", q_shape, k_shape, v_shape)
    bh, s, d = q_shape
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: D must be a multiple of 8 and "
                         f"at most {MAX_HEAD_DIM} (got {d})")
    if bh > MAX_BH:
        raise ValueError(f"flash_attention: BH must be at most {MAX_BH} "
                         f"(got {bh})")
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    if dtype == torch.bfloat16:
        bq, bk, threads = 128, 64, 384
        stages = 2 if dp == 256 else 4
        # padding to the swizzle's 1 KB period, q tiles of both consumer
        # warpgroups, the k and v rings, 1 + 4 * stages mbarriers
        smem = (1024 + (2 + 2 * stages) * (dp // 64) * BOX_BYTES
                + 8 * (1 + 4 * stages))
    else:
        bq, bk, threads, stages = 32, 32, 128, 1
        smem = 4 * (bq * dp + bk * (dp + 1) + bk * dp + bq * (bk + 1))
    return {"dp": dp, "bq": bq, "bk": bk, "stages": stages,
            "smem_bytes": smem, "threads": threads, "rep": rep,
            "ctas": -(-s // bq) * bh}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, S, D), k, v (BH_kv, S, D) -> (BH, S, D); ``window <= 0`` is
    unbounded."""
    global launches
    dtype = _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v},
                                dtypes=_build.LM_DTYPES)
    launch_plan(q.shape, k.shape, v.shape, dtype)
    _build.check_aligned("flash_attention", {"q": q, "k": k, "v": v})
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load()
    err = getattr(lib, _FN[dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
        k.shape[0], s, d, int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
