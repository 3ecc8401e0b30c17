"""Causal / sliding-window flash attention, and cross-attention, on the card.

Wrapper of the CUDA kernels in ``csrc/flash_attention.cu`` (the Hopper
counterpart of the TPU kernel ``repro.kernels.flash_attention``): online
softmax attention over q of shape (BH, S, D) with the heads folded into
the batch, and k, v of shape (BH_kv, S_kv, D) with BH_kv dividing BH: row
``bh // (BH // BH_kv)`` of k and v serves query row ``bh``
(``repeat_interleave``'s order), so an MQA or GQA layer's kv heads are
read in place.  S_kv differs from S only in a non-causal call with no
window: a cross-attention (whisper's decoder reading the encoder's
frames), which the TPU kernel does not take and the reference computes
in jnp; causal or windowed attention keeps S_kv = S
(``ref.attention_shapes``).  f32 accumulation, the output in the input
type.  bf16
runs on the tensor cores (``wgmma`` fed by TMA, three warpgroups a CTA;
at D <= 128 one persistent CTA an SM takes (q block, q head) items from
a counter, on 128-key tiles), f32 in exact f32 arithmetic
(register-tiled FMA, K and V copied by cp.async in pairs of tiles).  The
forward also writes each row's log-sum-exp (BH, S) in f32, which the
backward reads.  A head
dimension D that is not a multiple of 8 (gemma3-1b's smoke config has
12) is zero-padded in the wrapper to the next one (16 in the bf16
backward): q . k is unchanged, v's extra output columns are 0 and are
sliced away, and the kernels take the true D apart from the padded one
for the softmax scale 1 / sqrt(D) (:func:`launch_plan`).

The backward (no TPU counterpart) has an entry for each dtype, three
CUDA launches each: a small launch for Delta = rowsum(dO .* O), one for
dQ, one for dK and dV per kv block looping over the query heads that
share it (bf16 at D <= 128: two, the dq launch computing Delta for its
rows; dK and dV on 128-row kv blocks, 64 a consumer warpgroup).  The f32
dQ takes dS_ij = P_ij dO_i . (V_j - O_i), the difference inside the sum,
less each row's P-weighted mean of dS, so
that neither a row whose softmax sits nearly on one key nor the rounding
of the saved out and lse costs a row of small dQ its digits
(``ref.attention_bwd_plain``).  bf16 (``csrc/flash_attention_bwd.cu``)
is FA2's on the forward's machinery (``wgmma`` fed by TMA; two groups of query heads,
summed by a cluster of two CTAs, when the kv blocks alone would not fill
the card), D a multiple of 16; f32 (``csrc/flash_attention_bwd_f32.cu``)
is register-tiled exact f32 FMA on tiles copied by cp.async, as the f32
forward, with the same split into two query-head groups, D a multiple
of 8.  The wrappers take CUDA tensors, and ``meta`` tensors, for which
they allocate what a launch allocates on ``meta`` (the padded inputs,
the outputs, the log-sum-exp and the workspace), add the call's work
(:mod:`repro_torch.kernels.cost`) to the active recorder and launch
nothing: a dry run's route, which never materialises the (BH, S, S_kv)
scores of the plain version.  :class:`FlashAttention` is the autograd
Function that :func:`repro_torch.kernels.ops.flash_attention` calls: the
wrappers for CUDA and ``meta`` tensors, the plain versions of
``kernels/ref.py`` for CPU tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref
from repro_torch.kernels.ref import attention_shapes

launches = 0       # forward launches since the last reset (ops.reset_counts)
bwd_launches = 0   # backward calls (2 or 3 CUDA launches each) since then

_FN = {torch.float32: "repro_flash_attention_f32",
       torch.bfloat16: "repro_flash_attention_bf16"}
MAX_HEAD_DIM = 256
MAX_SMEM = 232448  # dynamic shared memory a CTA may use on an H100
BOX_BYTES = 64 * 128   # one TMA box of the bf16 kernel: 64 rows of 64 bf16
# The bf16 kernels' tiles at head dimension 64 and 128, as their sources
# have them: the forward's kv rows a tile (kBK2; 64 at 256) on a ring of 3
# stages, one persistent CTA an SM; the backward's dkdv kv rows a CTA
# (kBKV2; 64 a consumer; 64 a CTA at 256).
BF16_BK, BF16_STAGES = 128, 3
BF16_BWD_BKV, BF16_BWD_KV_STAGES = 128, 4
# The f32 kernels' tiles, as their sources have them: the forward's q rows a
# CTA, kv rows a tile and tiles in flight, a pair (kBQ32, kBK32, kStages32);
# the backward's dq launch q rows a CTA and kv rows a tile (kBQ, kBK), its
# dkdv launch kv rows a CTA and q rows a tile (kBKV, kBQT), and the tiles
# of a pair, which both launches stream (kStages).
F32_BQ, F32_BK, F32_STAGES = 64, 32, 2
F32_BWD_BQ, F32_BWD_BK, F32_BWD_BKV, F32_BWD_BQT = 48, 16, 32, 32
F32_BWD_STAGES = 2


def _f32_row(dp: int) -> int:
    """Floats a staged row of the f32 kernels takes at head dimension DP:
    the 128 columns a warp covers at least, padded by 4."""
    return max(dp, 128) + 4


def check_softcap(name: str, softcap) -> float:
    """``softcap`` as the float the C entries take (0 is no cap);
    ``ValueError`` for a negative or non-finite one."""
    cap = float(softcap)
    if not (math.isfinite(cap) and cap >= 0.0):
        raise ValueError(f"{name}: softcap must be finite and >= 0 (got "
                         f"{softcap!r})")
    return cap


def padded_head_dim(d: int, multiple: int = 8) -> int:
    """D rounded up to a multiple of ``multiple``: the head dimension the
    kernels read (8 for the forward and the f32 backward, 16 for the bf16
    backward)."""
    return -(-d // multiple) * multiple


def pad_head_dim(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``t`` (..., D) with zero columns up to ``d_pad``; ``t`` itself when
    D is ``d_pad``."""
    return t if t.shape[-1] == d_pad else F.pad(t, (0, d_pad - t.shape[-1]))


def launch_plan(q_shape, k_shape, v_shape, dtype: torch.dtype, *,
                causal: bool = True, window: int = 0) -> dict:
    """Shape checks (S_kv may differ from S only when ``causal`` is
    false and ``window`` is 0) and the launch of one call: the padded head
    dimension the kernel reads (D_PAD) and the softmax scale of the true
    D, the head dimension DP the kernel is compiled for, the key rows
    (S_KV), the q rows a CTA owns (BQ), the kv rows a tile holds (BK), the
    tiles in flight (the bf16 ring's stages, the f32 pair), the dynamic
    shared memory in bytes, threads a CTA, work items (q blocks times q
    heads) and CTAs: one an item, except the bf16 kernel at DP 64 and 128,
    whose persistent grid has one CTA an SM walking over the items
    (``persistent``).  The tiles are ``Bf16Cfg2``, ``Bf16Cfg`` and
    ``F32Cfg`` of the source, which asserts the same 227 KB limit when it
    compiles."""
    rep = attention_shapes("flash_attention", q_shape, k_shape, v_shape,
                           causal=causal, window=window)
    bh, s, d = q_shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: D must be at most "
                         f"{MAX_HEAD_DIM} (got {d})")
    d_pad = padded_head_dim(d)
    dp = 64 if d_pad <= 64 else 128 if d_pad <= 128 else 256
    boxes = dp // 64                 # 64-column boxes in a row
    persistent = dtype == torch.bfloat16 and dp <= 128
    if persistent:
        bq, bk, threads, stages = 128, BF16_BK, 384, BF16_STAGES
        # padding to the swizzle's 1 KB period, the q tiles of both
        # consumer warpgroups (64 rows), the k and v rings (128 rows),
        # 2 + 4 * stages mbarriers, the q tiles' work item
        smem = (1024 + 2 * boxes * BOX_BYTES
                + 2 * stages * boxes * 2 * BOX_BYTES + 8 * (2 + 4 * stages)
                + 16)
    elif dtype == torch.bfloat16:
        bq, bk, threads, stages = 128, 64, 384, 2
        # the q tiles of both consumer warpgroups, the k and v rings,
        # 1 + 4 * stages mbarriers
        smem = (1024 + (2 + 2 * stages) * boxes * BOX_BYTES
                + 8 * (1 + 4 * stages))
    else:
        bq, bk, threads, stages = F32_BQ, F32_BK, 256, F32_STAGES
        # Q, a pair of K and of V tiles, P (a pair's keys + 4 a row)
        ld = _f32_row(dp)
        smem = 4 * (bq * ld + 2 * stages * bk * ld + bq * (stages * bk + 4))
    items = -(-s // bq) * bh
    return {"d_pad": d_pad, "scale": 1.0 / math.sqrt(d), "dp": dp, "bq": bq,
            "bk": bk, "s_kv": k_shape[1], "stages": stages,
            "smem_bytes": smem,
            "threads": threads, "rep": rep, "items": items,
            "persistent": persistent,
            "ctas": min(items, _build.NUM_SMS) if persistent else items}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, lse: bool = False,
                    softcap: float = 0.0):
    """q (BH, S, D), k, v (BH_kv, S_kv, D) -> (BH, S, D); ``window <= 0``
    is unbounded; S_kv = S unless ``causal`` is false and ``window`` 0.
    ``softcap`` > 0 caps each scaled score s as softcap tanh(s / softcap)
    before the mask (the kernels' capped instantiations).  With ``lse``
    also each row's log-sum-exp of its scaled (capped) scores, (BH, S)
    f32."""
    global launches
    dtype = _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v},
                                dtypes=_build.LM_DTYPES)
    softcap = check_softcap("flash_attention", softcap)
    plan = launch_plan(q.shape, k.shape, v.shape, dtype, causal=causal,
                       window=window)
    d_pad = plan["d_pad"]
    _build.check_aligned("flash_attention", {"q": q, "k": k, "v": v})
    bh, s, d = q.shape
    q, k, v = (pad_head_dim(t, d_pad) for t in (q, k, v))
    out = torch.empty_like(q)
    # lse, and past it one word of scratch for the bf16 kernel (the
    # persistent grid's work counter, which the launcher zeroes)
    lse_buf = torch.empty(bh * s + 4, dtype=torch.float32, device=q.device)
    lse_out = lse_buf[:bh * s].view(bh, s)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_buf.data_ptr()]
    if dtype == torch.bfloat16:
        ptrs.append(lse_buf.data_ptr() + 4 * bh * s)
    if q.is_meta:
        cost.record("flash_attention", cost.flash_attention(
            (bh, s, d), (k.shape[0], k.shape[1], d), dtype, causal=causal,
            window=window, softcap=softcap))
    else:
        lib = _build.load()
        err = getattr(lib, _FN[dtype])(
            *ptrs, bh, k.shape[0], s, k.shape[1], d_pad, d,
            int(bool(causal)), int(window), softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention")
        launches += 1
    if d_pad != d:
        out = out[..., :d].contiguous()
    return (out, lse_out) if lse else out


BWD_PAD = 128        # rows of the backward's workspace: S rounded up


def bwd_plan(q_shape, k_shape, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The backward's launches at ``dtype``.  bf16 as
    ``csrc/flash_attention_bwd.cu`` has them: the dq launch's q rows a CTA
    (BQ, 64 a consumer warpgroup), kv rows a tile (BK) and stages; the
    dkdv launch's kv rows a CTA (BKV: 128 at DP 64 and 128, 64 a consumer
    warpgroup holding its rows' dK and dV, ``dkdv_split`` "rows"; 64 at
    256, the consumers split by gradient), q rows a tile (BQT), stages and
    query-head groups (a cluster of that many CTAs a kv block), the CUDA
    launches of a call (``launches``: the dq launch does the prep's work
    at DP 64 and 128); dynamic
    shared memory of each (after up to 1 KB of padding to the swizzle's
    period) and CTAs; and the f32 workspace's shape (lse log2 e and Delta,
    (2, BH, S_pad)).  f32 as ``csrc/flash_attention_bwd_f32.cu`` (its
    ``Cfg``, which asserts the same 227 KB limit when it compiles): 256
    threads a CTA; dq: 48 q rows a CTA (Q, dO and O staged), kv tiles of
    16 rows in pairs;
    dkdv: 32 kv rows a CTA (a cluster of ``groups`` CTAs, by the bf16
    rule), q tiles of 32 rows in pairs; staged rows of max(D_pad, 128) +
    4 floats, and a (BH, S) workspace (Delta).  ``d_pad``: the head
    dimension the launches read, D rounded up to a multiple of 8 (f32) or
    16 (bf16).  The dq launch runs over the S query rows, the dkdv launch
    over the S_kv rows of k (``k_shape``); the workspace follows S."""
    bh, s, d = q_shape
    bh_kv, s_kv = k_shape[0], k_shape[1]
    rep = bh // bh_kv
    d_pad = padded_head_dim(d, 8 if dtype == torch.float32 else 16)
    dp = 64 if d_pad <= 64 else 128 if d_pad <= 128 else 256
    if dtype == torch.float32:
        ld = _f32_row(dp)
        bq, bk = F32_BWD_BQ, F32_BWD_BK
        bkv, bqt, stages = F32_BWD_BKV, F32_BWD_BQT, F32_BWD_STAGES
        nkb = -(-s_kv // bkv)
        groups = 2 if rep >= 2 and nkb * bh_kv < 2 * _build.NUM_SMS else 1
        return {"d_pad": d_pad, "dp": dp, "bq": bq, "bk": bk, "bkv": bkv,
                "bqt": bqt, "launches": ("prep", "dq", "dkdv"),
                "stages": stages, "groups": groups, "threads": 256,
                # Q, dO, O; a pair of K and of V tiles; P and dS (a
                # pair's keys + 4 a row)
                "dq_smem_bytes": 4 * (3 * bq * ld + stages * 2 * bk * ld
                                      + 2 * bq * (stages * bk + 4)),
                # K, V; a pair of items' Q, dO, lse and Delta; P^T and
                # dS^T (a pair's q rows + 4 a row)
                "dkdv_smem_bytes": 4 * (2 * bkv * ld
                                        + stages * (2 * bqt * ld + 2 * bqt)
                                        + 2 * bkv * (stages * bqt + 4)),
                "dq_ctas": -(-s // bq) * bh,
                "dkdv_ctas": nkb * bh_kv * groups,
                "ws_shape": (bh, s)}
    tile = (dp // 64) * BOX_BYTES           # 64 rows of D
    bk = 32 if dp == 256 else 64
    dq_stages = 3 if dp == 256 else 4
    if dp <= 128:
        # each consumer owns 64 of the CTA's kv rows: k and v of both,
        # the ring of q and dO with lse2 and Delta (64 f32 each), 1 + 2
        # stages mbarriers
        bkv, kv_stages, split = BF16_BWD_BKV, BF16_BWD_KV_STAGES, "rows"
        dkdv_smem = (1024 + 4 * tile + kv_stages * (2 * tile + 2 * 256)
                     + 8 * (1 + 2 * kv_stages))
    else:
        # the two consumers share 64 kv rows, split by gradient: k and v,
        # the ring, two 64 x 64 f32 buffers of P^T, the mbarriers
        bkv, kv_stages, split = 64, 2, "gradient"
        dkdv_smem = (1024 + 2 * tile + kv_stages * (2 * tile + 2 * 256)
                     + 2 * 64 * 64 * 4 + 8 * (1 + 2 * kv_stages))
    nkb = -(-s_kv // bkv)
    groups = 2 if rep >= 2 and nkb * bh_kv < 2 * _build.NUM_SMS else 1
    # at DP <= 128 the dq launch also does the prep's work (Delta and
    # lse2 of its rows), with an o tile beside each consumer's q and dO
    prep = dp == 256
    return {"d_pad": d_pad, "dp": dp, "bq": 128, "bk": bk,
            "dq_stages": dq_stages,
            "bkv": bkv, "bqt": 64, "kv_stages": kv_stages, "groups": groups,
            "dkdv_split": split,
            "launches": (("prep",) if prep else ()) + ("dq", "dkdv"),
            # q and dO (and o) tiles of both consumers, the k and v rings,
            # 1 + 4 stages mbarriers
            "dq_smem_bytes": (1024 + (4 if prep else 6) * tile
                              + 2 * dq_stages * tile * bk // 64
                              + 8 * (1 + 4 * dq_stages)),
            "dkdv_smem_bytes": dkdv_smem,
            "dq_ctas": -(-s // 128) * bh,
            "dkdv_ctas": nkb * bh_kv * groups,
            "s_pad": -(-s // BWD_PAD) * BWD_PAD,
            "ws_shape": (2, bh, -(-s // BWD_PAD) * BWD_PAD)}


_BWD_FN = {torch.float32: "repro_flash_attention_bwd_f32",
           torch.bfloat16: "repro_flash_attention_bwd_bf16"}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0) -> tuple:
    """The gradients (dq, dk, dv) of :func:`flash_attention` from its
    inputs (k, v and so dk, dv with S_kv rows), its output ``o``, its
    ``lse`` and ``do``; f32 (exact FMA, D
    zero-padded to a multiple of 8) or bf16 (``wgmma``, D zero-padded to a
    multiple of 16), all in one dtype but the f32 ``lse``.  Three CUDA
    launches (Delta, dq, then dk and dv; two in bf16 at D <= 128, whose dq
    launch computes Delta).  ``softcap`` as in :func:`flash_attention`,
    whose ``lse`` of the capped scores this call reads: P = exp(cap t -
    lse) with t = tanh(s / cap), and every dS times 1 - t^2."""
    global bwd_launches
    dtype = _build.check_inputs("flash_attention_bwd",
                                {"q": q, "k": k, "v": v, "o": o, "do": do},
                                dtypes=_build.LM_DTYPES)
    softcap = check_softcap("flash_attention_bwd", softcap)
    launch_plan(q.shape, k.shape, v.shape, dtype, causal=causal,
                window=window)
    bh, s, d = q.shape
    _build.check_shape("flash_attention_bwd", "o", o, q.shape)
    _build.check_shape("flash_attention_bwd", "do", do, q.shape)
    _build.check_inputs("flash_attention_bwd", {"lse": lse},
                        dtypes=(torch.float32,))
    _build.check_shape("flash_attention_bwd", "lse", lse, (bh, s))
    _build.check_aligned("flash_attention_bwd",
                         {"q": q, "k": k, "v": v, "o": o, "do": do})
    plan = bwd_plan(q.shape, k.shape, dtype)
    d_pad = plan["d_pad"]
    q, k, v, o, do = (pad_head_dim(t, d_pad) for t in (q, k, v, o, do))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ws = torch.empty(plan["ws_shape"], dtype=torch.float32, device=q.device)
    if q.is_meta:
        cost.record("flash_attention_bwd", cost.flash_attention_bwd(
            (bh, s, d), (k.shape[0], k.shape[1], d), dtype, causal=causal,
            window=window, softcap=softcap))
    else:
        lib = _build.load()
        err = getattr(lib, _BWD_FN[dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, k.shape[0], s, k.shape[1],
            d_pad, d, int(bool(causal)), int(window), softcap,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "flash_attention_bwd")
        bwd_launches += 1
    if d_pad != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = flash_attention(q, k, v) with FA2's backward; saves q, k, v,
    out and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                softcap: float = 0.0):
        if q.is_cuda or q.is_meta:
            out, lse = flash_attention(q, k, v, causal=causal,
                                       window=window, lse=True,
                                       softcap=softcap)
        else:
            out, lse = ref.attention_plain(q, k, v, causal=causal,
                                           window=window, lse=True,
                                           softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        fn = (flash_attention_bwd if q.is_cuda or q.is_meta
              else ref.attention_bwd_plain)
        dq, dk, dv = fn(q, k, v, out, lse, do, causal=ctx.causal,
                        window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None
