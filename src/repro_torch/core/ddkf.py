"""DD-KF — the distributed Kalman-Filter solve of a decomposed CLS problem.

Each subdomain (= processor) iterates the *additive* Schwarz update:
given the current global iterate, it solves its local regularized VAR-KF
problem (eq. 25/27) and the updates are assembled (eq. 28).  The only
inter-subdomain coupling per iteration is

    Ax = sum_j A_j x_j            (one reduction of an m-vector)

plus the boundary/overlap averaging folded into the assembly — the
communication structure the paper counts in its overhead T^p_oh.

This module ports the single-device path of ``repro.core.ddkf``
(``solve_vmapped``: subdomains on the leading axis of a batch).  The
setup builds the local normal matrices with the ``gram`` kernel and the
iteration runs the fused ``schwarz_fwd``/``schwarz_bwd`` kernels (see
:mod:`repro_torch.kernels.ops`); the Cholesky factors and triangular
solves stay ``torch.linalg``, as the reference left them outside its
kernels.

Static shapes: local blocks are padded to the max block width; padded
columns carry an identity diagonal in the local normal matrix and zero
right-hand side, so their solution stays exactly zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import cls as cls_mod
from repro_torch.core import dd as dd_mod
from repro_torch.core import dydd as dydd_mod
from repro_torch.kernels import ops as ops_mod

# PackedDD fields kept on the host: the solve reads none of them.
HOST_FIELDS = ("cols", "mult_loc", "scatter_cols")


@dataclasses.dataclass(frozen=True)
class PackedDD:
    """Host-side packing of a Decomposition into padded device tensors.

    The :data:`HOST_FIELDS` stay numpy arrays: they keep the reference's
    fields for comparison and for building ``owner_slots``."""

    A_loc: torch.Tensor      # (p, m, w) local column blocks, zero-padded
    L_loc: torch.Tensor      # (p, w, w) Cholesky of local normal matrices
    cols: np.ndarray         # (p, w) global column index per local slot
                             # (or -1)
    mask: torch.Tensor       # (p, w) 1.0 for real columns, 0.0 for padding
    muov: torch.Tensor       # (p, w) mu on overlap slots (regularization)
    wdiv: torch.Tensor       # (p, w) mask / column-multiplicity: partition
                             # of unity so sum_i A_i (x_i * wdiv_i) == A x
    mult: torch.Tensor       # (n,) column multiplicity (overlap counting)
    mult_loc: np.ndarray     # (p, w) multiplicity gathered to local slots
                             # (1.0 on padding)
    scatter_cols: np.ndarray    # (p, w) cols with padding redirected to
                                # the dump slot n
    gather_cols: torch.Tensor   # (p, w) cols with padding clipped to 0 —
                                # the (mask-guarded) gather map
    owner_slots: torch.Tensor   # (n, K) flat (p*w) slots owning each
                                # column, ascending, padded with the dump
                                # slot p*w — the gather form of the
                                # scatter map, for a deterministic assembly
    r: torch.Tensor          # (m,) weight diagonal
    b: torch.Tensor          # (m,) stacked data
    n: int
    p: int
    w: int
    solve_kernel: str = "plain"   # resolved iteration path: "plain" |
                                  # "fused"

    @property
    def m(self) -> int:
        """Stacked row count (background + observation rows)."""
        return int(self.r.shape[0])

    @property
    def device(self) -> torch.device:
        return self.A_loc.device

    def edge_send_bytes(self, halo: "dd_mod.HaloExchange") -> dict:
        """Per-iteration bytes each endpoint of each halo edge sends on
        the neighbour-exchange path, priced at this packing's dtype."""
        return halo.edge_send_bytes(self.A_loc.element_size())

    def comm_stats(self, halo: "dd_mod.HaloExchange | None" = None,
                   comm: str = "allreduce",
                   mesh_shape: tuple | None = None) -> dict:
        """Modelled per-iteration communication volume for this packing
        (see :func:`comm_model`)."""
        return comm_model(self.n, self.m, self.p, self.A_loc.element_size(),
                          halo=halo, comm=comm, mesh_shape=mesh_shape)


def _axis_allreduce_elems(length: int, mesh_shape: tuple) -> list:
    """Per-device element sends of a hierarchical all-reduce, per mesh
    axis: outer axes pay a plain full-vector psum ring ((k - 1) * length),
    the innermost the reduce-scatter + all-gather pair
    (2 * (k - 1) / k * length)."""
    per_axis = []
    for i, k in enumerate(mesh_shape):
        k = int(k)
        if k <= 1:
            per_axis.append(0.0)
        elif i == len(mesh_shape) - 1:
            per_axis.append(2.0 * (k - 1) / k * length)
        else:
            per_axis.append(float(k - 1) * length)
    return per_axis


def comm_model(n: int, m: int, p: int, itemsize: int,
               halo: "dd_mod.HaloExchange | None" = None,
               comm: str = "allreduce",
               mesh_shape: tuple | None = None) -> dict:
    """Modelled per-iteration send volume of one sharded Schwarz sweep.

    The model counts payload bytes leaving each device per Schwarz
    iteration, the quantity the paper's overhead term T^p_oh charges:

      * ``mvec`` — the (m,) observation-space product every path
        all-reduces, priced per mesh axis (``mesh_shape``, outer to
        inner; default ``(p,)``) — see :func:`_axis_allreduce_elems`.
      * state exchange — ``comm="allreduce"``: the (n,)-assembled
        estimate through the same per-axis hierarchy, *independent of
        the overlap width*; ``comm="neighbour"``: only the halo slots,
        ``sum(|shared|)`` elements per edge endpoint — proportional to
        the overlap width s and to nothing else.

    Returns a JSON-ready dict with per-device and total bytes, the
    per-axis mvec breakdown, and the per-edge breakdown (empty for the
    allreduce path).
    """
    if comm not in ("allreduce", "neighbour"):
        raise ValueError(f"comm must be 'allreduce' or 'neighbour' "
                         f"(got {comm!r})")
    mesh_shape = tuple(int(k) for k in (mesh_shape or (p,)))
    if int(np.prod(mesh_shape)) != p:
        raise ValueError(f"mesh_shape {mesh_shape} does not factor "
                         f"p={p} devices")
    mvec_axis = [e * itemsize for e in _axis_allreduce_elems(m, mesh_shape)]
    mvec_dev = float(sum(mvec_axis))
    if comm == "allreduce":
        state_axis = [e * itemsize
                      for e in _axis_allreduce_elems(n, mesh_shape)]
        state_dev = np.full((p,), sum(state_axis))
        per_edge: dict = {}
        rounds = 0
    else:
        if halo is None:
            raise ValueError("comm='neighbour' needs the decomposition's "
                             "halo_exchange metadata")
        state_dev = halo.device_send_bytes(itemsize).astype(np.float64)
        per_edge = halo.edge_send_bytes(itemsize)
        rounds = halo.rounds
    return {
        "comm": comm,
        "mesh_shape": list(mesh_shape),
        "mvec_bytes_per_device": mvec_dev,
        "mvec_bytes_per_device_per_axis": [float(b) for b in mvec_axis],
        "state_bytes_per_device_max": float(state_dev.max(initial=0.0)),
        "state_bytes_per_device_mean": float(state_dev.mean()
                                             if p else 0.0),
        "state_bytes_total": float(state_dev.sum()),
        "bytes_per_iter_total": float(state_dev.sum() + p * mvec_dev),
        "per_edge_bytes": per_edge,
        "permute_rounds": rounds,
    }


# Iteration-kernel selection: "plain" is the einsum composition of the
# reference's "jnp" path (three passes over A_loc per iteration);
# "fused" runs the two-pass schwarz_fwd/schwarz_bwd step through
# kernels.ops (the CUDA kernels on the card, their plain versions on CPU
# tensors); "auto" picks "fused" on the card and "plain" elsewhere.
SOLVER_KERNELS = ("auto", "plain", "fused")
GRAM_MODES = ops_mod.MODES


def _resolve_solver_kernel(solver_kernel: str, device: torch.device) -> str:
    if solver_kernel not in SOLVER_KERNELS:
        raise ValueError(f"solver_kernel must be one of {SOLVER_KERNELS} "
                         f"(got {solver_kernel!r})")
    if solver_kernel == "auto":
        return "fused" if device.type == "cuda" else "plain"
    return solver_kernel


def owner_slots(scatter_cols: np.ndarray, n: int) -> np.ndarray:
    """(n, K) flat slot indices owning each column, ascending, padded with
    the dump slot ``p*w`` (K = the largest column multiplicity, >= 1).

    The gather form of the ``scatter_cols`` map: summing the K gathered
    values in order assembles the global vector without a scatter-add,
    whose order on the card is free once a column has three or more
    owners (2D corners, k-d tree halos)."""
    flat = np.asarray(scatter_cols).reshape(-1)
    order = np.argsort(flat, kind="stable")
    order = order[flat[order] < n]
    owned = flat[order]
    counts = np.bincount(owned, minlength=n)
    out = np.full((n, max(1, int(counts.max(initial=0)))), flat.size,
                  dtype=np.int64)
    rank = np.arange(owned.size) - (np.cumsum(counts) - counts)[owned]
    out[owned, rank] = order
    return out


def pack(prob: cls_mod.CLSProblem, dec: dd_mod.Decomposition,
         mu: float = 1.0, gram_mode: str = "auto",
         solver_kernel: str = "auto") -> PackedDD:
    """Pack a whole CLS problem (operator and data) on its device."""
    A, b, r = prob.stacked()
    return with_rhs(pack_operator(A.cpu().numpy(), r.cpu().numpy(), dec,
                                  mu=mu, gram_mode=gram_mode,
                                  solver_kernel=solver_kernel,
                                  device=A.device), b)


def _factor_batched(A_loc: torch.Tensor, r: torch.Tensor,
                    diag_add: torch.Tensor,
                    gram_mode: str = "auto") -> torch.Tensor:
    """Batched local normal matrices + Cholesky factors, on device.

    N_i = A_i^T diag(r) A_i comes from ``kernels.ops.gram`` (the CUDA
    kernel on the card, the plain version on CPU tensors); ``diag_add``
    carries the mu-regularization on overlap slots plus the identity on
    padded slots that keeps every factor nonsingular."""
    p = A_loc.shape[0]
    N = ops_mod.gram(A_loc, r.expand(p, -1).contiguous(), mode=gram_mode)
    return torch.linalg.cholesky(N + torch.diag_embed(diag_add.to(N.dtype)))


def pack_operator(A, r, dec: dd_mod.Decomposition, mu: float = 1.0,
                  gram_mode: str = "auto", solver_kernel: str = "auto",
                  device=None) -> PackedDD:
    """Pack the *operator* part of a decomposed CLS problem.

    ``A`` (m, n) and ``r`` (m,) are host arrays.  The host slices the p
    column blocks into the padded (p, m, w) layout and copies it to
    ``device`` (``None`` = the card); the p local normal matrices
    N_i = A_i^T diag(r) A_i and their Cholesky factors are then built on
    the device in one batched shot (:func:`_factor_batched`).  The
    packing depends only on (A, r, dec), not on the data vector b, so the
    streaming engine runs it for cycle t+1 while the device is solving
    cycle t, then injects the cycle's rhs with :func:`with_rhs`.

    ``gram_mode`` selects the gram path (:data:`GRAM_MODES`) and
    ``solver_kernel`` the per-iteration step path the solves will run
    (:data:`SOLVER_KERNELS`, resolved here from the device).

    The returned ``PackedDD`` carries a zero rhs; pass it through
    :func:`with_rhs` before solving.
    """
    device = device_mod.resolve(device)
    if gram_mode not in GRAM_MODES:
        raise ValueError(f"gram_mode must be one of {GRAM_MODES} "
                         f"(got {gram_mode!r})")
    solve_kernel = _resolve_solver_kernel(solver_kernel, device)
    A_np = np.asarray(A)
    m, n = A_np.shape
    p = dec.p
    w = max(1, max(int(np.asarray(c).shape[0]) for c in dec.col_sets))

    # Per-column multiplicity is the decomposition's source of truth: the
    # halo columns (multiplicity > 1) carry the mu-regularization and the
    # 1/multiplicity partition-of-unity assembly weight, on any graph.
    counts = dec.column_multiplicity
    halo_mu = dec.has_overlap and mu > 0.0

    A_loc = np.zeros((p, m, w), dtype=A_np.dtype)
    cols = -np.ones((p, w), dtype=np.int64)
    mask = np.zeros((p, w), dtype=A_np.dtype)
    muov = np.zeros((p, w), dtype=A_np.dtype)
    for i, c in enumerate(dec.col_sets):
        c = np.asarray(c)
        k = c.shape[0]
        A_loc[i, :, :k] = A_np[:, c]
        cols[i, :k] = c
        mask[i, :k] = 1.0
        if halo_mu:
            muov[i, :k] = mu * (counts[c] > 1).astype(muov.dtype)
    mult_at = np.maximum(counts, 1)[np.clip(cols, 0, n - 1)]
    wdiv = mask / mult_at
    mult_loc = np.where(cols >= 0, mult_at, 1.0)
    scatter_cols = np.where(cols >= 0, cols, n)
    gather_cols = np.where(cols >= 0, cols, 0)

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    A_loc_t = dev(A_loc)
    ftype = A_loc_t.dtype
    r_t = dev(np.asarray(r), ftype)
    # mu on overlap slots; identity on padded slots (mask == 0).
    L_loc = _factor_batched(A_loc_t, r_t, dev(muov + (1.0 - mask)),
                            gram_mode=gram_mode)
    return PackedDD(A_loc=A_loc_t, L_loc=L_loc, cols=cols,
                    mask=dev(mask), muov=dev(muov), wdiv=dev(wdiv),
                    mult=dev(np.maximum(counts, 1), ftype),
                    mult_loc=mult_loc.astype(A_np.dtype),
                    scatter_cols=scatter_cols,
                    gather_cols=dev(gather_cols),
                    owner_slots=dev(owner_slots(scatter_cols, n)),
                    r=r_t, b=torch.zeros((m,), dtype=ftype, device=device),
                    n=n, p=p, w=w, solve_kernel=solve_kernel)


def with_rhs(packed: PackedDD, b) -> PackedDD:
    """Inject the data vector b = [y0; y1] into an operator-only packing."""
    return dataclasses.replace(packed, b=torch.as_tensor(
        b, dtype=packed.A_loc.dtype, device=packed.device))


def _chol_solve(L, rhs):
    """Batched L L^T z = rhs: L (p, w, w), rhs (p, w) -> (p, w)."""
    z = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def _rhs_plain(packed: PackedDD, x_loc):
    """Local right-hand sides as the reference's jnp composition: three
    passes over A_loc."""
    A = packed.A_loc
    Ax = torch.einsum("pmw,pw->pm", A, x_loc * packed.wdiv).sum(dim=0)
    resid = (packed.b - Ax)[None] + torch.einsum("pmw,pw->pm", A, x_loc)
    return (torch.einsum("pmw,pm->pw", A, packed.r[None] * resid)
            + packed.muov * x_loc) * packed.mask


def _rhs_fused(packed: PackedDD, x_loc):
    """Local right-hand sides in two passes over A_loc: the
    schwarz_fwd/schwarz_bwd kernels."""
    y, u = ops_mod.schwarz_fwd(packed.A_loc, x_loc, packed.wdiv)
    return ops_mod.schwarz_bwd(packed.A_loc, packed.r, packed.b,
                               y.sum(dim=0), u, x_loc, packed.muov,
                               packed.mask)


def solve_vmapped(packed: PackedDD, iters: int = 60, damping: float = 1.0,
                  residual_history: bool = False, x0=None):
    """Additive-Schwarz DD-KF; returns the assembled global estimate.

    With ``residual_history=True`` the call returns ``(x, hist)`` where
    ``hist[k]`` is the global update norm ``||x_loc^{k+1} - x_loc^k||_F``
    (identical numerics; one extra (iters,) output).

    ``x0`` is an optional (n,) global warm start: the iteration begins
    from its local gather instead of zeros.

    The per-iteration local right-hand side follows the packing's
    resolved ``solve_kernel`` ("plain" or "fused"); the Cholesky solves,
    damping and the overlap averaging of eq. 28 are shared.
    """
    rhs_fn = _rhs_fused if packed.solve_kernel == "fused" else _rhs_plain
    if x0 is None:
        x_loc = torch.zeros((packed.p, packed.w), dtype=packed.A_loc.dtype,
                            device=packed.device)
    else:
        x_loc = gather_local(packed, torch.as_tensor(
            x0, dtype=packed.A_loc.dtype, device=packed.device))
    hist = []
    for _ in range(iters):
        new = _chol_solve(packed.L_loc, rhs_fn(packed, x_loc)) * packed.mask
        x_loc2 = (1.0 - damping) * x_loc + damping * new
        # Overlap consistency: average duplicated columns globally, then
        # gather back (eq. 28).
        nxt = gather_local(packed, assemble(packed, x_loc2))
        if residual_history:
            hist.append(torch.linalg.norm(nxt - x_loc))
        x_loc = nxt
    x = assemble(packed, x_loc)
    if not residual_history:
        return x
    return x, (torch.stack(hist) if hist else
               torch.zeros((0,), dtype=x.dtype, device=x.device))


def assemble(packed: PackedDD, x_loc: torch.Tensor) -> torch.Tensor:
    """Global vector from local iterates, averaging overlaps.

    Gathers each column's owner slots (``owner_slots``) and adds them in
    ascending slot order, so the sum is the same on every run and every
    device."""
    flat = torch.cat([(x_loc * packed.mask).reshape(-1),
                      x_loc.new_zeros((1,))])
    got = flat[packed.owner_slots]
    acc = got[:, 0]
    for k in range(1, got.shape[1]):
        acc = acc + got[:, k]
    return acc / packed.mult


def gather_local(packed: PackedDD, x_glob: torch.Tensor) -> torch.Tensor:
    return x_glob[packed.gather_cols] * packed.mask


def ddkf_with_dydd(prob: cls_mod.CLSProblem, obs_locations: np.ndarray,
                   p: int, overlap: int = 0, iters: int = 60,
                   mu: float = 1.0):
    """Balance observations with DyDD, decompose, and solve with DD-KF.

    Returns (x_ddkf, dydd_result, decomposition).
    """
    res = dydd_mod.dydd_1d(obs_locations, p)
    dec = dd_mod.decompose_1d(prob.n, res.boundaries, overlap=overlap)
    packed = pack(prob, dec, mu=mu)
    x = solve_vmapped(packed, iters=iters)
    return x, res, dec
