"""Fused additive-Schwarz iteration step on the card — the DD-KF hot loop.

Wrappers of the CUDA kernels in ``csrc/schwarz_step.cu`` (the Hopper
counterparts of the TPU kernels ``repro.kernels.schwarz_step``):

* :func:`schwarz_fwd` — ONE pass over A_i gives y_i = A_i (x_i * wdiv_i)
  and u_i = A_i x_i.  The cross-subdomain sum Ax = sum_i y_i stays
  outside the kernel.
* :func:`schwarz_bwd` — ONE pass over A_i gives
  rhs_i = (A_i^T (r * (b - Ax + u_i)) + muov_i * x_i) * mask_i with the
  residual formed on chip and never stored.

Both are memory-bound matrix-vector products.  A CTA's producer thread
streams rows of one subdomain into a ring of shared memory with 1-D bulk
copies (each row from the 16-byte granule holding its first element, so
any contiguous view serves) and eight consumer warps reduce them; each
launch aims at two CTAs an SM, so one subdomain fills the card.  The
forward takes the rows in chunks of :func:`chunk_rows` (m), a CTA a
chunk and a warp a row.  The backward takes them in parts of
:func:`part_rows` (m) rows, a CTA a part and a row segment (a row cut in
several while the parts alone would not fill the card), a thread a
column with its sum in registers, into a (p, parts, w) scratch whose
parts a second launch adds in order.  Every sum's order is fixed by
(m, w), so a subdomain's bits do not depend on p, its place in the batch
or its pointer's alignment.  :func:`fwd_plan` and :func:`bwd_plan`
restate the launches.

Both take CUDA tensors, and ``meta`` tensors, for which they allocate
their outputs on ``meta``, add the call's work
(:mod:`repro_torch.kernels.cost`) to the active recorder and launch
nothing; :mod:`repro_torch.kernels.ops` routes CPU tensors to the plain
versions.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, cost

fwd_launches = 0   # kernel launches since the last reset
bwd_launches = 0

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_SIZE = {torch.float64: 8, torch.float32: 4}

# The source's constants (kWarps, kFill, kParts, kMinRows, kMaxRows,
# kMinCols, kStageBytes, kStages, kTileBytes, kSmemMax, kHead,
# kFinishThreads).
WARPS = 8                      # consumer warps a CTA, beside one producer
THREADS = 32 * WARPS + 32
FILL = 2 * _build.NUM_SMS      # CTAs a launch aims at
PARTS = 32                     # backward parts a subdomain aims at
MIN_ROWS, MAX_ROWS = 8, 256    # rows a chunk or part; a backward part's most
MIN_COLS = 32                  # columns a backward row segment, at least
STAGE_BYTES = 16384            # bytes of rows a stage holds (one row least)
STAGES = 4                     # stages in the ring
TILE_BYTES = 16384             # bytes of a backward row segment, at most
SMEM_MAX = 232448
HEAD = 128                     # the mbarriers' bytes
FINISH_THREADS = 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _clamp(v: int, lo: int, hi: int) -> int:
    return min(max(v, lo), hi)


def chunk_rows(m: int) -> int:
    """Rows a forward chunk: max(MIN_ROWS, m // FILL).  Depends on m
    alone."""
    return max(m // FILL, MIN_ROWS)


def part_rows(m: int) -> int:
    """Rows a backward part: ceil(m / PARTS) within [MIN_ROWS, MAX_ROWS].
    Depends on m alone."""
    return _clamp(_cdiv(m, PARTS), MIN_ROWS, MAX_ROWS)


def row_chunks(m: int) -> list:
    """The (first, end) rows of each forward chunk of a subdomain."""
    rows = chunk_rows(m)
    return [(r, min(m, r + rows)) for r in range(0, m, rows)]


def bwd_parts(m: int) -> list:
    """The (first, end) rows of each backward part of a subdomain: the
    rows one entry of the scratch sums, in row order."""
    rows = part_rows(m)
    return [(r, min(m, r + rows)) for r in range(0, m, rows)]


def _stride(seg: int) -> int:
    return _cdiv(seg, 16) * 16 + 16


def _ring(plan: dict, seg: int, fixed: int) -> None:
    stride = _stride(seg)
    plan["stage_rows"] = _clamp(STAGE_BYTES // seg, 1, plan["rows"])
    slot = plan["stage_rows"] * stride
    plan["stages"] = _clamp((SMEM_MAX - fixed) // slot, 0, STAGES)
    plan["stride"] = stride
    plan["smem_bytes"] = fixed + plan["stages"] * slot


@functools.lru_cache(maxsize=64)
def fwd_plan(shape, dtype: torch.dtype) -> dict:
    """The forward's launch at a (p, m, w) shape: a CTA a chunk of
    ``rows`` rows (``chunks`` a subdomain; grid ``grid``), its ring of
    ``stages`` stages of ``stage_rows`` rows (``stride`` bytes a row in
    shared memory), xs staged beside it where it fits (``stage_x``), and
    its dynamic shared memory.  ``stages`` < 1: w is too wide for a row
    a stage, and the launch refuses.  Cached: do not modify."""
    p, m, w = shape
    size = _SIZE[dtype]
    rows = chunk_rows(m)
    plan = {"rows": rows, "chunks": _cdiv(m, rows), "cols": w, "tiles": 1,
            "threads": THREADS}
    seg = w * size
    xs = 2 * w * size   # staged where two stages fit beside it
    plan["stage_x"] = (HEAD + xs + 2 * _clamp(STAGE_BYTES // seg, 1, rows)
                       * _stride(seg) <= SMEM_MAX)
    _ring(plan, seg, HEAD + (xs if plan["stage_x"] else 0))
    plan["grid"] = (plan["chunks"], p)
    return plan


@functools.lru_cache(maxsize=64)
def bwd_plan(shape, dtype: torch.dtype) -> dict:
    """The backward's two launches at a (p, m, w) shape: the partial
    launch, a CTA a part of ``rows`` rows (``parts`` a subdomain) and a
    row segment of ``cols`` columns (``tiles`` segments a row), with its
    ring and dynamic shared memory (grid ``grid``); the (p, ``parts``, w)
    ``scratch`` the wrapper allocates; and the finish launch's grid
    ``finish_grid``.  Cached: do not modify."""
    p, m, w = shape
    size = _SIZE[dtype]
    rows = part_rows(m)
    parts = _cdiv(m, rows)
    fewest = _cdiv(w, TILE_BYTES // size)
    tiles = _clamp(FILL // (p * parts), fewest,
                   max(fewest, _cdiv(w, MIN_COLS)))
    cols = _cdiv(w, tiles)
    plan = {"rows": rows, "parts": parts, "cols": cols,
            "tiles": _cdiv(w, cols), "threads": THREADS}
    _ring(plan, cols * size, HEAD + _cdiv(rows * size, 16) * 16)
    plan["grid"] = (parts, plan["tiles"], p)
    plan["scratch"] = (p, parts, w)
    plan["finish_grid"] = (_cdiv(w, FINISH_THREADS), p)
    return plan


def _pw(A: torch.Tensor, name: str) -> tuple:
    if A.dim() != 3 or min(A.shape) < 1:
        raise ValueError(f"{name}: A must be (p, m, w) with p, m, w >= 1 "
                         f"(got {tuple(A.shape)})")
    return tuple(A.shape)


def schwarz_fwd(A, x, wdiv):
    """A: (p, m, w), x/wdiv: (p, w) -> (y, u), both (p, m)."""
    global fwd_launches
    dtype = _build.check_inputs("schwarz_fwd", {"A": A, "x": x,
                                                "wdiv": wdiv})
    p, m, w = _pw(A, "schwarz_fwd")
    for k, t in (("x", x), ("wdiv", wdiv)):
        _build.check_shape("schwarz_fwd", k, t, (p, w))
    if fwd_plan((p, m, w), dtype)["stages"] < 1:
        raise ValueError(f"schwarz_fwd: a row of w = {w} does not fit the "
                         f"shared memory of a CTA")
    y = torch.empty((p, m), dtype=dtype, device=A.device)
    u = torch.empty((p, m), dtype=dtype, device=A.device)
    if A.is_meta:
        cost.record("schwarz_fwd", cost.schwarz_fwd(A.shape, dtype))
        return y, u
    lib = _build.load()
    fn = getattr(lib, f"repro_schwarz_fwd_{_SUFFIX[dtype]}")
    err = fn(A.data_ptr(), x.data_ptr(), wdiv.data_ptr(), y.data_ptr(),
             u.data_ptr(), p, m, w,
             torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "schwarz_fwd")
    fwd_launches += 1
    return y, u


def schwarz_bwd(A, r, b, Ax, u, x, muov, mask):
    """A: (p, m, w), r/b/Ax: (m,), u: (p, m), x/muov/mask: (p, w) ->
    rhs: (p, w)."""
    global bwd_launches
    dtype = _build.check_inputs(
        "schwarz_bwd", {"A": A, "r": r, "b": b, "Ax": Ax, "u": u, "x": x,
                        "muov": muov, "mask": mask})
    p, m, w = _pw(A, "schwarz_bwd")
    for k, t in (("r", r), ("b", b), ("Ax", Ax)):
        _build.check_shape("schwarz_bwd", k, t, (m,))
    _build.check_shape("schwarz_bwd", "u", u, (p, m))
    for k, t in (("x", x), ("muov", muov), ("mask", mask)):
        _build.check_shape("schwarz_bwd", k, t, (p, w))
    plan = bwd_plan((p, m, w), dtype)
    part = torch.empty(plan["scratch"], dtype=dtype, device=A.device)
    out = torch.empty((p, w), dtype=dtype, device=A.device)
    if A.is_meta:
        cost.record("schwarz_bwd", cost.schwarz_bwd(A.shape, dtype))
        return out
    lib = _build.load()
    fn = getattr(lib, f"repro_schwarz_bwd_{_SUFFIX[dtype]}")
    err = fn(A.data_ptr(), r.data_ptr(), b.data_ptr(), Ax.data_ptr(),
             u.data_ptr(), x.data_ptr(), muov.data_ptr(), mask.data_ptr(),
             part.data_ptr(), out.data_ptr(), p, m, w, plan["parts"],
             torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "schwarz_bwd")
    bwd_launches += 1
    return out
