"""Mamba-2 SSD chunked scan on the card.

Wrapper of the CUDA kernel ``csrc/ssd_scan.cu`` (the Hopper counterpart of
the TPU kernel ``repro.kernels.ssd_scan``) in the head-folded layout:
x (BH, S, P), dt (BH, S), A (BH,), and B, C (BH / rep, S, N), whose row
``bh // rep`` serves head ``bh``.  f32 only (the prefill casts to f32
before the scan).  It returns y (BH, S, P) and the state after the last
chunk (BH, N, P), the decode cache that the TPU kernel keeps in scratch.
It takes CUDA tensors, and ``meta`` tensors, for which it allocates what
a launch allocates on ``meta`` (outputs and workspaces), adds the call's
work (:mod:`repro_torch.kernels.cost`) to the active recorder and
launches nothing; :func:`repro_torch.kernels.ops.ssd_scan` routes CPU
tensors to the plain version.

One call is five CUDA launches on the current stream (cum, cb, states,
pass, out; ``csrc/ssd_scan.cu``), and ``launches`` counts calls.  Their
workspaces are allocated here: the in-chunk cumulative decay (BH, S) in
f64, C B^T per group and chunk (BH / rep, S / chunk, chunk, chunk) and
the chunk states (BH, S / chunk, N, P) in f32 (134 MB at the Mamba-2
1.3B prefill shape).

The backward (``csrc/ssd_scan_bwd.cu``, no TPU counterpart) gives dx,
ddt, dA, dB and dC of y in five CUDA launches (ychunk, rpass, col, row,
dcum), every product in 3xTF32 on the tensor cores, from the forward's
cum, C B^T and state workspaces (which :class:`SsdScan` saves) and an f32
and an f64 workspace allocated here; f32, P at most 64, the chunk at
most 256.  :class:`SsdScan` is the autograd Function that
:func:`repro_torch.kernels.ops.ssd_scan` calls: the wrappers for CUDA and
``meta`` tensors, the plain versions of ``kernels/ref.py`` for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels import ref
from repro_torch.kernels.ref import ssd_chunk

launches = 0       # forward calls since the last reset (ops.reset_counts)
bwd_launches = 0   # backward calls (five CUDA launches each) since then

MAX_N = 128        # B's slab rows in shared memory are sized for it
MAX_CHUNK = 1024   # cum, dt and the decay weights of a chunk in shared memory
MAX_BH = 65535     # the grid's z extent
MAX_P_BWD = 64     # the backward's tiles hold 64 columns of P
MAX_CHUNK_BWD = 256   # its strip of the heads' sum of dG in shared memory
TILE_BWD = 64      # rows of the backward's col and row tiles
PASS_BWD = 256     # state elements an rpass CTA of the backward owns


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 256, workspaces: bool = False) -> tuple:
    """-> (y (BH, S, P), final state (BH, N, P)), both f32; with
    ``workspaces`` also (cum, C B^T, the state before each chunk), what
    the backward reads."""
    global launches
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    _build.check_inputs("ssd_scan", tensors, dtypes=(torch.float32,))
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"ssd_scan: x must be (BH, S, P) with BH, S, P >= 1"
                         f" (got {tuple(x.shape)})")
    bh, s, p = x.shape
    if B.dim() != 3 or B.shape[0] < 1 or bh % B.shape[0]:
        raise ValueError(f"ssd_scan: B must be (BH / rep, S, N) for a whole "
                         f"rep (got {tuple(B.shape)} for BH = {bh})")
    groups, n = B.shape[0], B.shape[2]
    chunk = ssd_chunk(s, chunk)
    if n % 8 or not 8 <= n <= MAX_N:
        raise ValueError(f"ssd_scan: N must be a multiple of 8 and at most "
                         f"{MAX_N} (got {n})")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan: the chunk must be at most {MAX_CHUNK} "
                         f"(got {chunk})")
    if bh > MAX_BH:
        raise ValueError(f"ssd_scan: BH must be at most {MAX_BH} (got {bh})")
    _build.check_shape("ssd_scan", "dt", dt, (bh, s))
    _build.check_shape("ssd_scan", "A", A, (bh,))
    _build.check_shape("ssd_scan", "B", B, (groups, s, n))
    _build.check_shape("ssd_scan", "C", C, (groups, s, n))
    _build.check_aligned("ssd_scan", {"B": B, "C": C})
    y = torch.empty_like(x)
    final = torch.empty((bh, n, p), dtype=x.dtype, device=x.device)
    nc = s // chunk
    cum = torch.empty((bh, s), dtype=torch.float64, device=x.device)
    cb = torch.empty((groups, nc, chunk, chunk), dtype=x.dtype,
                     device=x.device)
    states = torch.empty((bh, nc, n, p), dtype=x.dtype, device=x.device)
    if x.is_meta:
        cost.record("ssd_scan", cost.ssd_scan(x.shape, B.shape, chunk))
    else:
        lib = _build.load()
        err = lib.repro_ssd_scan_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), final.data_ptr(), cum.data_ptr(),
            cb.data_ptr(), states.data_ptr(), bh, s, p, n, bh // groups,
            chunk, torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "ssd_scan")
        launches += 1
    if workspaces:
        return y, final, (cum, cb, states)
    return y, final


def bwd_splits(bh: int, groups: int, s: int, chunk: int) -> int:
    """How many parts the backward's col launch splits a group's heads
    into: the fewest (a power of two, at most 8 and at most rep) that give
    two waves of col CTAs on the card."""
    rep, nc, tiles = bh // groups, s // chunk, -(-chunk // TILE_BWD)
    h = 1
    while (2 * h <= min(rep, 8)
           and groups * nc * tiles * h < 2 * _build.NUM_SMS):
        h *= 2
    return h


def bwd_smem_bytes() -> dict:
    """Dynamic shared memory of the backward's col and row launches, by
    the formulas of ``csrc/ssd_scan_bwd.cu`` (chunk at most 256, N 128, P
    64, 64-row tiles with padded rows; a row CTA owns 64 columns of N)."""
    t, lda, ldb, ldna = TILE_BWD, 68, 72, 132
    col = (8 * (MAX_CHUNK_BWD + 4 * t)
           + 4 * (MAX_CHUNK_BWD + 6 * t + t * ldna + t * lda + MAX_N * ldb
                  + 2 * t * lda + (MAX_CHUNK_BWD // t) * t * t))
    row = 8 * 3 * t + 4 * (4 * t * lda + t * ldb)
    return {"col": col, "row": row}


def bwd_workspaces(bh: int, groups: int, s: int, p: int, n: int,
                   chunk: int) -> tuple:
    """Elements of the backward's f32 and f64 workspaces, by the formulas
    of ``csrc/ssd_scan_bwd.cu``."""
    nc = s // chunk
    tiles = -(-chunk // TILE_BWD)
    slices = -(-(n * p) // PASS_BWD)
    h = bwd_splits(bh, groups, s, chunk)
    halves = -(-n // 64)
    return (bh * nc * n * p + h * groups * nc * chunk * chunk
            + h * groups * s * n + bh * s + bh * nc * slices,
            bh * s * tiles + (halves + 1) * bh * s + bh * nc * tiles)


def ssd_scan_bwd(x, dt, A, B, C, dy, saved, *, chunk: int = 256) -> tuple:
    """The gradients (dx, ddt, dA, dB, dC) of :func:`ssd_scan`'s y, from
    its inputs, ``dy`` and ``saved``, the forward's workspaces (cum, C B^T,
    the state before each chunk); all f32."""
    global bwd_launches
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "dy": dy}
    _build.check_inputs("ssd_scan_bwd", tensors, dtypes=(torch.float32,))
    bh, s, p = x.shape
    groups, n = B.shape[0], B.shape[2]
    chunk = ssd_chunk(s, chunk)
    if p > MAX_P_BWD or n > MAX_N or chunk > MAX_CHUNK_BWD or bh > MAX_BH:
        raise ValueError(f"ssd_scan_bwd: P must be at most {MAX_P_BWD}, N "
                         f"at most {MAX_N}, the chunk at most "
                         f"{MAX_CHUNK_BWD} "
                         f"and BH at most {MAX_BH} (got P {p}, N {n}, "
                         f"chunk {chunk}, BH {bh})")
    nc = s // chunk
    cum, cb, states = saved
    _build.check_shape("ssd_scan_bwd", "dy", dy, (bh, s, p))
    _build.check_shape("ssd_scan_bwd", "cum", cum, (bh, s))
    _build.check_shape("ssd_scan_bwd", "G", cb, (groups, nc, chunk, chunk))
    _build.check_shape("ssd_scan_bwd", "states", states, (bh, nc, n, p))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    n32, n64 = bwd_workspaces(bh, groups, s, p, n, chunk)
    ws = torch.empty(n32, dtype=torch.float32, device=x.device)
    ws64 = torch.empty(n64, dtype=torch.float64, device=x.device)
    if x.is_meta:
        cost.record("ssd_scan_bwd", cost.ssd_scan_bwd(x.shape, B.shape,
                                                      chunk))
        return dx, ddt, dA, dB, dC
    lib = _build.load()
    err = lib.repro_ssd_scan_bwd_f32(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), cum.data_ptr(), cb.data_ptr(),
        states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ws.data_ptr(), ws64.data_ptr(), bh,
        s, p, n, bh // groups, chunk, bwd_splits(bh, groups, s, chunk),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan_bwd")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


class SsdScan(torch.autograd.Function):
    """(y, final state) = ssd_scan(...) with the backward of y; the final
    state is not differentiable.  On the card it saves the forward's
    workspaces for the backward; on the CPU the plain backward recomputes
    what it needs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        if x.is_cuda or x.is_meta:
            y, final, saved = ssd_scan(x, dt, A, B, C, chunk=chunk,
                                       workspaces=True)
        else:
            y, final = ref.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                          state=True)
            saved = ()
        ctx.save_for_backward(x, dt, A, B, C, *saved)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, *saved = ctx.saved_tensors
        dy = dy.contiguous()
        if x.is_cuda or x.is_meta:
            grads = ssd_scan_bwd(x, dt, A, B, C, dy, saved, chunk=ctx.chunk)
        else:
            grads = ref.ssd_scan_bwd_plain(x, dt, A, B, C, dy,
                                           chunk=ctx.chunk)
        return (*grads, None)
