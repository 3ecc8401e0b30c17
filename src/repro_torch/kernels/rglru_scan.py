"""RG-LRU linear recurrence on the card, forward and backward.

Wrappers of the CUDA kernels in ``csrc/rglru_scan.cu`` (the forward is the
Hopper counterpart of the TPU kernel ``repro.kernels.rglru_scan``; the
backward has no TPU counterpart): h_t = a_t h_{t-1} + b_t over the
sequence axis of (B, S, W) inputs, f32 or bf16 in, the state in f32, the
output in the input type, by one of two paths chosen by shape
(:func:`fwd_plan`): TMA loads of 64-step boxes into an mbarrier ring where
the row stride is a multiple of 16 bytes and the pointers 16-byte aligned,
direct loads otherwise, with the same sums in the same order; and its
gradients from h and dh by a chunked reverse scan over S (three CUDA
launches a call: each chunk's local scan, the carry across chunks, each
chunk's scan again from its carry).  The wrappers take CUDA tensors, and
``meta`` tensors, for which they allocate what a launch allocates on
``meta``, add the call's work (:mod:`repro_torch.kernels.cost`) to the
active recorder and launch nothing.  :class:`RglruScan` is the autograd
Function that :func:`repro_torch.kernels.ops.rglru_scan` calls: the
wrappers for CUDA and ``meta`` tensors, the plain versions of
``kernels/ref.py`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref

launches = 0       # forward launches since the last reset (ops.reset_counts)
bwd_launches = 0   # backward calls (three CUDA launches each) since then
last_path = None   # the path of the last forward launch: "tma" or "direct"

_FN = {torch.float32: "repro_rglru_scan_f32",
       torch.bfloat16: "repro_rglru_scan_bf16"}
_CARRY_FN = {torch.float32: "repro_rglru_scan_bwd_carry_f32",
             torch.bfloat16: "repro_rglru_scan_bwd_carry_bf16"}
_BWD_FN = {torch.float32: "repro_rglru_scan_bwd_f32",
           torch.bfloat16: "repro_rglru_scan_bwd_bf16"}
MAX_B = 65535   # the grid's y (forward) and z (backward) extent
# The forward's TMA path, as the source has it: channels a CTA (kTmaCh),
# steps a box (kTmaSteps), boxes of a and b in flight (kTmaStages) and
# staged tiles of h (kTmaOut).
TMA_CH, TMA_STEPS, TMA_STAGES, TMA_OUT = 32, 64, 4, 2
BWD_CHUNK = ref.RGLRU_BWD_CHUNK   # steps a chunk of the backward
MAX_CHUNKS = 65535   # the backward grid's y extent


def _check(name: str, tensors: dict):
    dtype = _build.check_inputs(name, tensors, dtypes=_build.LM_DTYPES)
    a = next(iter(tensors.values()))
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"{name}: a must be (B, S, W) with B, S, W >= 1"
                         f" (got {tuple(a.shape)})")
    if a.shape[0] > MAX_B:
        raise ValueError(f"{name}: B must be at most {MAX_B} (got "
                         f"{a.shape[0]})")
    for key, t in tensors.items():
        _build.check_shape(name, key, t, a.shape)
    return dtype


def fwd_plan(shape, dtype: torch.dtype, aligned: bool = True) -> dict:
    """The forward's launch at a (B, S, W) shape: the TMA path where a row
    of W elements is a multiple of 16 bytes (W % 4 == 0 in f32, W % 8 == 0
    in bf16) and every pointer is 16-byte aligned (``aligned``), a CTA of
    two warps on TMA_CH channels of one batch row with TMA_STAGES boxes of
    TMA_STEPS steps of a and b in flight and TMA_OUT tiles of h, and its
    dynamic shared memory (``TmaCfg`` of the source, which asserts the same
    227 KB limit); else the direct path, a thread a channel in CTAs of 64,
    no shared memory."""
    B, S, W = shape
    size = torch.empty((), dtype=dtype).element_size()
    if aligned and (W * size) % 16 == 0:
        box = TMA_CH * TMA_STEPS * size
        return {"path": "tma", "threads": 64, "ctas": -(-W // TMA_CH) * B,
                "stages": TMA_STAGES,
                "smem_bytes": 128 + box * (2 * TMA_STAGES + TMA_OUT)
                + 16 * TMA_STAGES}
    return {"path": "direct", "threads": 64, "ctas": -(-W // 64) * B,
            "stages": 0, "smem_bytes": 0}


def rglru_scan(a: torch.Tensor, b: torch.Tensor, *,
               direct: bool = False) -> torch.Tensor:
    """a, b: (B, S, W) -> h: (B, S, W) with h_t = a_t h_{t-1} + b_t, by
    the path :func:`fwd_plan` chooses (its name is left in ``last_path``);
    ``direct`` takes the direct path at any shape, to compare the two."""
    global launches, last_path
    dtype = _check("rglru_scan", {"a": a, "b": b})
    B, S, W = a.shape
    h = torch.empty_like(a)
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, h))
    chosen = "direct" if direct else fwd_plan(a.shape, dtype,
                                               aligned)["path"]
    if a.is_meta:
        cost.record("rglru_scan", cost.rglru_scan(a.shape, dtype))
        return h
    lib = _build.load()
    err = getattr(lib, _FN[dtype])(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        int(chosen == "tma"), torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "rglru_scan")
    launches += 1
    last_path = chosen
    return h


def bwd_workspace_shape(shape) -> tuple:
    """The backward's f32 workspace for a (B, S, W) call: each chunk's
    (u_k, then its incoming carry x_k) and A_k, (2, B, nc, W) with nc =
    ceil(S / BWD_CHUNK)."""
    B, S, W = shape
    return (2, B, -(-S // BWD_CHUNK), W)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> tuple:
    """The gradients (da, db) of :func:`rglru_scan` from its output h and
    dh, all (B, S, W) in one dtype; three CUDA launches (chunk, carry,
    out), the steps of ``ref.rglru_scan_bwd_plain``, in two calls: da and
    db are allocated while the first two run."""
    global bwd_launches
    dtype = _check("rglru_scan_bwd", {"a": a, "h": h, "dh": dh})
    B, S, W = a.shape
    ws_shape = bwd_workspace_shape(a.shape)
    if ws_shape[2] > MAX_CHUNKS:
        raise ValueError(f"rglru_scan_bwd: S must be at most "
                         f"{MAX_CHUNKS * BWD_CHUNK} (got {S})")
    ws = torch.empty(ws_shape, dtype=torch.float32, device=a.device)
    if a.is_meta:
        cost.record("rglru_scan_bwd", cost.rglru_scan_bwd(a.shape, dtype))
        return torch.empty_like(a), torch.empty_like(a)
    lib = _build.load()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(lib, _CARRY_FN[dtype])(a.data_ptr(), dh.data_ptr(),
                                         ws.data_ptr(), B, S, W, stream)
    _build.check(err, "rglru_scan_bwd")
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    err = getattr(lib, _BWD_FN[dtype])(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), ws.data_ptr(),
        da.data_ptr(), db.data_ptr(), B, S, W, stream)
    _build.check(err, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db


class RglruScan(torch.autograd.Function):
    """h = rglru_scan(a, b) with the reverse scan as its backward; saves a
    and h."""

    @staticmethod
    def forward(ctx, a, b):
        h = (rglru_scan(a, b) if a.is_cuda or a.is_meta
             else ref.rglru_scan_plain(a, b))
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        dh = dh.contiguous()
        if a.is_cuda or a.is_meta:
            return rglru_scan_bwd(a, h, dh)
        return ref.rglru_scan_bwd_plain(a, h, dh)
