"""Mamba-2 SSD chunked scan on the card.

Wrapper of the CUDA kernel ``csrc/ssd_scan.cu`` (the Hopper counterpart of
the TPU kernel ``repro.kernels.ssd_scan``) in the head-folded layout:
x (BH, S, P), dt (BH, S), A (BH,), and B, C (BH / rep, S, N), whose row
``bh // rep`` serves head ``bh``.  f32 only (the prefill casts to f32
before the scan).  It returns y (BH, S, P) and the state after the last
chunk (BH, N, P), the decode cache that the TPU kernel keeps in scratch.
It takes CUDA tensors only; :func:`repro_torch.kernels.ops.ssd_scan`
routes CPU tensors to the plain version.

One call is five CUDA launches on the current stream (cum, cb, states,
pass, out; ``csrc/ssd_scan.cu``), and ``launches`` counts calls.  Their
workspaces are allocated here: the in-chunk cumulative decay (BH, S) in
f64, C B^T per group and chunk (BH / rep, S / chunk, chunk, chunk) and
the chunk states (BH, S / chunk, N, P) in f32 (134 MB at the Mamba-2
1.3B prefill shape).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk

launches = 0   # calls since the last reset (see ops.reset_counts)

MAX_N = 128        # B's slab rows in shared memory are sized for it
MAX_CHUNK = 1024   # cum, dt and the decay weights of a chunk in shared memory
MAX_BH = 65535     # the grid's z extent


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 256) -> tuple:
    """-> (y (BH, S, P), final state (BH, N, P)), both f32."""
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
    lib = _build.load()
    err = lib.repro_ssd_scan_f32(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), final.data_ptr(), cum.data_ptr(),
        cb.data_ptr(), states.data_ptr(), bh, s, p, n, bh // groups, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    launches += 1
    return y, final
