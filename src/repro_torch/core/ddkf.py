"""DD-KF — the distributed Kalman-Filter solve of a decomposed CLS problem.

Each subdomain (= processor) iterates the *additive* Schwarz update:
given the current global iterate, it solves its local regularized VAR-KF
problem (eq. 25/27) and the updates are assembled (eq. 28).  The only
inter-subdomain coupling per iteration is

    Ax = sum_j A_j x_j            (one reduction of an m-vector)

plus the boundary/overlap averaging folded into the assembly — the
communication structure the paper counts in its overhead T^p_oh.

This module ports the paths of ``repro.core.ddkf``:

  * ``solve_vmapped`` — subdomains on the leading axis of a batch on one
    device;
  * ``solve_fleet`` — independent problems on a leading axis, solved one
    after another, with ``stack_packed`` and ``pad_packed_width`` to
    build the stack;
  * ``solve_shardmap`` — one rank per subdomain of a
    :class:`~repro_torch.runtime.mesh.ProcessMesh`: each rank runs the
    same host program on its own block and the ranks meet in collectives
    (the all-reduce of the m-vector each iteration, and the overlap
    exchange: a global assembly or neighbour-only rounds);
  * ``solve_window_stack`` — independent Parareal windows by subdomains
    on a ``("time", "sub")`` mesh.

The setup builds the local normal matrices with the ``gram`` kernel and
the iteration runs the fused ``schwarz_fwd``/``schwarz_bwd`` kernels (see
:mod:`repro_torch.kernels.ops`); the Cholesky factors and triangular
solves stay ``torch.linalg``, as the reference left them outside its
kernels.

Static shapes: local blocks are padded to the max block width; padded
columns carry an identity diagonal in the local normal matrix and zero
right-hand side, so their solution stays exactly zero.
"""
from __future__ import annotations

import dataclasses
import time

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
    fields for comparison and for building ``owner_slots``.

    A per-rank packing (``pack_operator(..., subdomains=...)``) holds the
    device blocks of a run of subdomains only: ``A_loc``, ``L_loc``,
    ``mask``, ``muov``, ``wdiv`` and ``gather_cols`` have one row per
    subdomain held, starting at subdomain ``first``; every other field,
    and ``n``, ``p`` and ``w``, are those of the whole packing."""

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
    first: int = 0                # subdomain of the first device row

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
    padded slots that keeps every factor nonsingular.

    The factors are returned row-major: ``cholesky`` gives each one in
    column-major strides, and ``stack_packed`` (``torch.stack``) copies
    them row-major, where the triangular solves round differently — so
    a fleet member would not solve bit for bit as the packing alone.
    Each matrix is factored alone: on the card a batch of several goes
    to another cuSOLVER routine than one, and a rank's packing of its
    own block must equal the same row of the whole packing bit for
    bit."""
    p = A_loc.shape[0]
    N = ops_mod.gram(A_loc, r.expand(p, -1).contiguous(), mode=gram_mode)
    N = N + torch.diag_embed(diag_add.to(N.dtype))
    return torch.stack([torch.linalg.cholesky(Ni) for Ni in N])


def pack_operator(A, r, dec: dd_mod.Decomposition, mu: float = 1.0,
                  gram_mode: str = "auto", solver_kernel: str = "auto",
                  device=None, subdomains: range | None = None) -> PackedDD:
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

    ``subdomains`` (a ``range`` of consecutive subdomains) packs a rank's
    share only: the host slices, uploads and factors just those blocks,
    which equal the same rows of the whole packing bit for bit (see
    :class:`PackedDD`).

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
    subs = range(p) if subdomains is None else subdomains
    if (len(subs) < 1 or subs.step != 1 or subs.start < 0
            or subs.stop > p):
        raise ValueError(f"subdomains must be a nonempty range of "
                         f"consecutive subdomains of 0..{p - 1} (got "
                         f"{subdomains!r})")

    # Per-column multiplicity is the decomposition's source of truth: the
    # halo columns (multiplicity > 1) carry the mu-regularization and the
    # 1/multiplicity partition-of-unity assembly weight, on any graph.
    counts = dec.column_multiplicity
    halo_mu = dec.has_overlap and mu > 0.0

    A_loc = np.zeros((len(subs), m, w), dtype=A_np.dtype)
    cols = -np.ones((p, w), dtype=np.int64)
    mask = np.zeros((p, w), dtype=A_np.dtype)
    muov = np.zeros((p, w), dtype=A_np.dtype)
    for i, c in enumerate(dec.col_sets):
        c = np.asarray(c)
        k = c.shape[0]
        if i in subs:
            A_loc[i - subs.start, :, :k] = A_np[:, c]
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

    rows = slice(subs.start, subs.stop)
    A_loc_t = dev(A_loc)
    ftype = A_loc_t.dtype
    r_t = dev(np.asarray(r), ftype)
    # mu on overlap slots; identity on padded slots (mask == 0).
    L_loc = _factor_batched(A_loc_t, r_t, dev((muov + (1.0 - mask))[rows]),
                            gram_mode=gram_mode)
    return PackedDD(A_loc=A_loc_t, L_loc=L_loc, cols=cols,
                    mask=dev(mask[rows]), muov=dev(muov[rows]),
                    wdiv=dev(wdiv[rows]),
                    mult=dev(np.maximum(counts, 1), ftype),
                    mult_loc=mult_loc.astype(A_np.dtype),
                    scatter_cols=scatter_cols,
                    gather_cols=dev(gather_cols[rows]),
                    owner_slots=dev(owner_slots(scatter_cols, n)),
                    r=r_t, b=torch.zeros((m,), dtype=ftype, device=device),
                    n=n, p=p, w=w, solve_kernel=solve_kernel,
                    first=subs.start)


def with_rhs(packed: PackedDD, b) -> PackedDD:
    """Inject the data vector b = [y0; y1] into an operator-only packing."""
    return dataclasses.replace(packed, b=torch.as_tensor(
        b, dtype=packed.A_loc.dtype, device=packed.device))


def pad_packed_width(packed: PackedDD, w_new: int) -> PackedDD:
    """Re-pad a packing to a larger local block width ``w_new``.

    Different cycles of a stream decompose with different max block
    widths (DyDD moves boundaries), so their packings cannot be stacked
    (:func:`stack_packed` requires equal ``w``).  Padding widens every
    per-slot field with the same conventions ``pack_operator`` uses for
    its own padding — zero columns in ``A_loc``, identity diagonal in
    ``L_loc``, ``cols=-1``/``mask=0``, multiplicity 1, scatter to the
    dump slot ``n`` — so the padded slots solve to exactly zero and the
    assembled estimate is unchanged up to reduction order.
    ``owner_slots`` holds flat ``i*w + k`` slots, so it is rebuilt from
    the padded ``scatter_cols``, not padded.  Returns ``packed`` itself
    when ``w_new == packed.w``.
    """
    if w_new < packed.w:
        raise ValueError(f"cannot shrink a packing: w={packed.w} -> "
                         f"{w_new}")
    if w_new == packed.w:
        return packed
    pad = w_new - packed.w
    rows, w = packed.A_loc.shape[0], packed.w
    L = packed.L_loc.new_zeros((rows, w_new, w_new))
    L[:, :w, :w] = packed.L_loc
    diag = torch.arange(w, w_new, device=packed.device)
    L[:, diag, diag] = 1.0
    pad2 = ((0, 0), (0, pad))
    scatter_cols = np.pad(packed.scatter_cols, pad2,
                          constant_values=packed.n)

    def widen(t):
        return torch.nn.functional.pad(t, (0, pad))

    return dataclasses.replace(
        packed,
        A_loc=widen(packed.A_loc),
        L_loc=L,
        cols=np.pad(packed.cols, pad2, constant_values=-1),
        mask=widen(packed.mask),
        muov=widen(packed.muov),
        wdiv=widen(packed.wdiv),
        mult_loc=np.pad(packed.mult_loc, pad2, constant_values=1.0),
        scatter_cols=scatter_cols,
        gather_cols=widen(packed.gather_cols),
        owner_slots=torch.as_tensor(owner_slots(scatter_cols, packed.n),
                                    device=packed.device),
        w=w_new)


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


# ---------------------------------------------------------------------------
# Fleet path: independent *problems* on a leading batch axis.
# ---------------------------------------------------------------------------

def _stack_key(pk: PackedDD) -> tuple:
    return (pk.n, pk.p, pk.w, pk.m, pk.solve_kernel, pk.A_loc.dtype)


def stack_packed(packs) -> PackedDD:
    """Stack same-shape packings onto a leading *problem* axis.

    Every data field gains a leading axis of size ``len(packs)`` (the
    fleet/cohort axis): ``torch.stack`` for the tensors, ``np.stack`` for
    the :data:`HOST_FIELDS`.  The meta fields — which must agree exactly
    across the stack, including the resolved ``solve_kernel`` — are
    carried through unchanged; a mismatch raises ``ValueError``.
    ``owner_slots`` may differ in width (the largest column multiplicity
    of each packing): narrower ones are padded with the dump slot, which
    adds an exact zero to the assembly.  The result is what
    :func:`solve_fleet` consumes.
    """
    packs = list(packs)
    if not packs:
        raise ValueError("stack_packed needs at least one packing")
    key0 = _stack_key(packs[0])
    for pk in packs[1:]:
        if _stack_key(pk) != key0:
            raise ValueError(
                f"cannot stack packings with different shapes/kernels: "
                f"{_stack_key(pk)} vs {key0} — bucket them into separate "
                f"cohorts")
    ref = packs[0]
    K = max(pk.owner_slots.shape[1] for pk in packs)
    dump = ref.p * ref.w
    fields = {}
    for f in dataclasses.fields(PackedDD):
        vals = [getattr(pk, f.name) for pk in packs]
        if f.name in HOST_FIELDS:
            fields[f.name] = np.stack(vals)
        elif f.name == "owner_slots":
            fields[f.name] = torch.stack([torch.nn.functional.pad(
                v, (0, K - v.shape[1]), value=dump) for v in vals])
        elif isinstance(vals[0], torch.Tensor):
            fields[f.name] = torch.stack(vals)
        else:
            fields[f.name] = vals[0]
    return PackedDD(**fields)


def _member(stacked: PackedDD, s: int) -> PackedDD:
    """Problem ``s`` of a stack: contiguous views of its rows."""
    return dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[s]
        for f in dataclasses.fields(PackedDD)
        if isinstance(getattr(stacked, f.name), (torch.Tensor, np.ndarray))})


def solve_fleet(stacked, iters: int = 60, damping: float = 1.0,
                residual_history: bool = False, mesh=None,
                axis: str = "fleet", x0=None):
    """Solve every problem of a stacked cohort.

    On one device this is a loop of :func:`solve_vmapped` over the
    leading problem axis — what the reference's ``lax.map`` does.  Each
    member is a contiguous view of the stack, so the fleet results equal
    the standalone per-problem solves.  Returns the (S, n) stacked
    estimates, or ``(x, hist)`` with ``hist`` of shape (S, iters) under
    ``residual_history=True``.  ``x0`` (single-device path only) is an
    optional (S, n) stack of global warm starts, one per problem (see
    :func:`solve_vmapped`).

    With ``mesh`` (a :class:`repro_torch.runtime.mesh.ProcessMesh`) every
    rank calls this with the same cohort, and the S members spread over
    the k ranks of the ``axis`` mesh axis: the rank at index r of that
    axis solves members ``r * S / k ... (r + 1) * S / k - 1`` and reads
    only those, then every rank all-gathers the (S, n) estimates (and
    the histories) over ``axis``.  ``stacked`` is then the stacked cohort
    (the rank reads its members' rows) or the list of the S packings
    themselves (the rank stacks nothing; the reference takes them
    stacked, and ranks that share a card would each hold all S).  A
    member's bits do not depend on the batch or the rank, so each equals
    its standalone :func:`solve_vmapped` bitwise.  S must be a multiple
    of k (the fleet server pads its cohorts with copies of member 0).  A
    rank whose members fail makes every rank raise
    (:meth:`~repro_torch.runtime.mesh.ProcessMesh.raise_any`).
    """
    if mesh is None:
        outs = [solve_vmapped(_member(stacked, s), iters=iters,
                              damping=damping,
                              residual_history=residual_history,
                              x0=None if x0 is None else x0[s])
                for s in range(int(stacked.A_loc.shape[0]))]
        if not residual_history:
            return torch.stack(outs)
        return (torch.stack([x for x, _ in outs]),
                torch.stack([h for _, h in outs]))
    if x0 is not None:
        raise NotImplementedError(
            "solve_fleet warm start is single-device only (the sharded "
            "fleet path has no x0 plumbing)")
    _mesh_axes(mesh, axis)
    k = int(mesh.shape[axis])
    listed = not isinstance(stacked, PackedDD)
    S = len(stacked) if listed else int(stacked.A_loc.shape[0])
    if S % k:
        raise ValueError(
            f"cohort size {S} does not divide over the {k}-device "
            f"'{axis}' mesh axis — pad the cohort to a multiple of {k}")
    r = mesh.index(axis)
    mine = range(r * (S // k), (r + 1) * (S // k))
    err, xs, hs = None, [], []
    try:
        for s in mine:
            pk = stacked[s] if listed else _member(stacked, s)
            out = solve_vmapped(pk, iters=iters, damping=damping,
                                residual_history=residual_history)
            xs.append(out[0] if residual_history else out)
            if residual_history:
                hs.append(out[1])
    except Exception as exc:   # agreed below: every rank raises
        err = exc
    mesh.raise_any(err)
    x = mesh.all_gather(torch.stack(xs), axis)
    if not residual_history:
        return x
    return x, mesh.all_gather(torch.stack(hs), axis)


# ---------------------------------------------------------------------------
# Distributed paths: subdomains (and Parareal windows) over the ranks of a
# ProcessMesh.  Every rank runs this code on its own share; the ranks meet
# in the mesh's collectives.
# ---------------------------------------------------------------------------

# Dense-network regime switch: when the stacked row count m is at least
# this multiple of n, the (m,) observation-space product dominates the
# per-iteration traffic and the sharded solve reduce-scatters it along
# the innermost mesh axis instead of a plain psum.
MVEC_SCATTER_RATIO = 2.0


def _mesh_axes(mesh, axis) -> tuple:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"mesh has no axis {a!r} (has "
                             f"{tuple(mesh.shape)})")
    return axes


def _block(packed: PackedDD, i: int) -> dict:
    """Subdomain i's device block of a whole or per-rank packing, as
    (1, ...) rows, plus its index maps on the device."""
    j = i - packed.first
    rows = int(packed.A_loc.shape[0])
    if not 0 <= j < rows:
        raise ValueError(
            f"this rank solves subdomain {i} but the packing holds "
            f"subdomains {packed.first}..{packed.first + rows - 1}")
    dev = packed.device
    return {
        "A": packed.A_loc[j:j + 1], "L": packed.L_loc[j:j + 1],
        "mask": packed.mask[j:j + 1], "muov": packed.muov[j:j + 1],
        "wdiv": packed.wdiv[j:j + 1], "gath": packed.gather_cols[j],
        "scat": torch.as_tensor(packed.scatter_cols[i], device=dev),
        "mloc": torch.as_tensor(packed.mult_loc[i],
                                dtype=packed.A_loc.dtype, device=dev)}


def solve_shardmap(packed: PackedDD, mesh, axis="sub", iters: int = 60,
                   damping: float = 1.0, comm: str = "allreduce",
                   halo: "dd_mod.HaloExchange | None" = None,
                   mvec: str = "auto", residual_history: bool = False,
                   return_per_device: bool = False):
    """The additive-Schwarz DD-KF with one rank per subdomain.

    Every rank of ``mesh`` (a :class:`repro_torch.runtime.mesh.
    ProcessMesh`) calls this with the same arguments; ``axis`` names the
    mesh axis, or the tuple of axes, the subdomains run over — rank
    ``r * pc + c`` of a ``("row", "col")`` mesh solves subdomain
    ``r * pc + c``.  ``packed`` is the whole packing or this rank's
    per-rank packing (``pack_operator(..., subdomains=range(i, i + 1))``);
    either way the rank uploads nothing more and solves its own (1, m, w)
    block with the packing's step path: the ``schwarz_fwd`` kernel, the
    all-reduce of its m-vector, ``schwarz_bwd`` and two triangular solves
    (``"fused"``), or the reference's ``_local_update`` composition
    (``"plain"``).

    Per iteration the ranks all-reduce the (m,) product — ``mvec="psum"``
    as a plain psum, ``"scatter"`` as a reduce-scatter and all-gather on
    the innermost axis; ``"auto"`` picks scatter when m >=
    :data:`MVEC_SCATTER_RATIO` n — and then make the overlap consistent:

      * ``comm="allreduce"`` — assemble the (n,) estimate (reduce-scatter
        and all-gather) and gather the rank's slots back;
      * ``comm="neighbour"`` — ``halo.rounds`` point-to-point rounds over
        the decomposition's coloured edge schedule (``halo`` =
        ``dec.halo_exchange``), moving only the halo slots; slot ``w`` of
        the padded local vector is the dump.

    One full assembly after the last iteration gives every rank the same
    (n,) estimate, bit for bit.  The paths agree with
    :func:`solve_vmapped` up to the order of the sums.

    Returns ``x``; with ``residual_history`` also ``hist`` (the psum'd
    global update norm per iteration, the same on every rank), as
    ``(x, hist)``; with ``return_per_device`` also ``times``, appended
    last: ``times[i]`` is rank i's seconds from the start of its solve to
    a fence after its last iteration, all-gathered in subdomain order so
    every rank holds all p.
    """
    axes = _mesh_axes(mesh, axis)
    sizes = [int(mesh.shape[a]) for a in axes]
    if int(np.prod(sizes)) != packed.p:
        raise ValueError(
            f"mesh axes {axes} have {int(np.prod(sizes))} devices but the "
            f"packing has p={packed.p} subdomains")
    if comm not in ("allreduce", "neighbour"):
        raise ValueError(f"comm must be 'allreduce' or 'neighbour' "
                         f"(got {comm!r})")
    if comm == "neighbour":
        if halo is None:
            raise ValueError(
                "comm='neighbour' needs the halo-exchange schedule: pass "
                "halo=dec.halo_exchange (cached on the Decomposition)")
        if halo.p != packed.p or halo.w != packed.w:
            raise ValueError(
                f"halo schedule shape (p={halo.p}, w={halo.w}) does not "
                f"match the packing (p={packed.p}, w={packed.w})")
    if mvec == "auto":
        mvec = ("scatter" if packed.m >= MVEC_SCATTER_RATIO * packed.n
                else "psum")
    if mvec not in ("psum", "scatter"):
        raise ValueError(f"mvec must be 'auto', 'psum' or 'scatter' "
                         f"(got {mvec!r})")
    n, m, w = packed.n, packed.m, packed.w
    # The innermost axis carries the scatters: pad the reduced vectors so
    # they split evenly (the n-vector keeps one extra slot as the dump).
    ks = sizes[-1]
    n_pad = -(-(n + 1) // ks) * ks
    m_pad = -(-m // ks) * ks
    i = mesh.index(axes)
    blk = _block(packed, i)
    A, L, mask, muov, wdiv = (blk[k] for k in
                              ("A", "L", "mask", "muov", "wdiv"))
    if comm == "neighbour":
        pack_i = torch.as_tensor(halo.pack_idx[i], dtype=torch.long,
                                 device=packed.device)
        unpack_i = torch.as_tensor(halo.unpack_idx[i], dtype=torch.long,
                                   device=packed.device)

    def mvec_allreduce(part):
        if mvec == "psum":
            return mesh.psum(part, axes)
        if m_pad > m:
            part = torch.cat([part, part.new_zeros(m_pad - m)])
        return mesh.axis_allreduce(part, axes)[:m]

    def assemble_all(x1):
        # Padding parks on slot n (< n_pad) with value zero.
        part = x1.new_zeros(n_pad)
        part[blk["scat"]] = (x1 * mask)[0]
        return mesh.axis_allreduce(part, axes)[:n] / packed.mult

    def exchange_allreduce(x1):
        return assemble_all(x1)[blk["gath"]][None] * mask

    def exchange_neighbour(x1):
        # Own contribution plus the halo slots received over the directed
        # rounds, divided by the local multiplicity: exactly halo.rounds
        # exchanges however many edges meet here.
        xm_pad = torch.cat([(x1 * mask)[0], x1.new_zeros(1)])
        acc = xm_pad.clone()
        for rnd in range(halo.rounds):
            got = mesh.ppermute(xm_pad[pack_i[rnd]], halo.perms[rnd], axes)
            acc.index_add_(0, unpack_i[rnd], got)
        return (acc[:w] / blk["mloc"])[None]

    exchange = (exchange_neighbour if comm == "neighbour"
                else exchange_allreduce)

    def step(x1):
        if packed.solve_kernel == "fused":
            y, u = ops_mod.schwarz_fwd(A, x1, wdiv)
            Ax = mvec_allreduce(y[0])
            rhs = ops_mod.schwarz_bwd(A, packed.r, packed.b, Ax, u, x1,
                                      muov, mask)
        else:
            A0, x0 = A[0], x1[0]
            Ax = mvec_allreduce(A0 @ (x0 * wdiv[0]))
            resid = packed.b - Ax + A0 @ x0
            rhs = ((A0.T @ (packed.r * resid) + muov[0] * x0)
                   * mask[0])[None]
        new = _chol_solve(L, rhs) * mask
        return exchange((1.0 - damping) * x1 + damping * new)

    t0 = time.perf_counter()
    x1 = torch.zeros((1, w), dtype=packed.A_loc.dtype, device=packed.device)
    hist = []
    for _ in range(iters):
        nxt = step(x1)
        if residual_history:
            d2 = mesh.psum(((nxt - x1) ** 2).sum().reshape(1), axes)
            hist.append(torch.sqrt(d2[0]))
        x1 = nxt
    device_mod.block(x1)
    elapsed = time.perf_counter() - t0
    # One full assembly at the end (both paths): the global estimate.
    out = [assemble_all(x1)]
    if residual_history:
        out.append(torch.stack(hist) if hist else
                   x1.new_zeros((0,)))
    if return_per_device:
        times = mesh.all_gather(torch.tensor([elapsed], dtype=torch.float64),
                                axes)
        out.append([float(t) for t in times])
    return out[0] if len(out) == 1 else tuple(out)


def solve_window_stack(windows, mesh, time_axis: str = "time",
                       sub_axis: str = "sub", iters: int = 60,
                       damping: float = 1.0, x0=None) -> torch.Tensor:
    """Solve K independent Parareal windows on a ``("time", "sub")`` mesh.

    ``windows`` is the list of K rhs-injected whole packings of one shape
    (the reference takes them stacked; here each rank stacks only its
    own share, which keeps ranks that share a card from holding K copies
    each).  Rank (t, s) holds windows ``t * Kl ... (t + 1) * Kl - 1`` and
    subdomains ``s * pl ... (s + 1) * pl - 1`` (Kl = K / kt, pl = p / ks)
    and runs the reference's batched additive-Schwarz composition on
    them; every collective (the psum of the (m,) products, the
    reduce-scatter and all-gather of the overlap assembly) runs on the
    rank's ``sub`` group, so windows never communicate.  Each rank
    assembles its subdomains' part of a window in ascending slot order
    before the reduction.

    ``x0`` is an optional (K, n) stack of global warm starts.  Returns the
    (K, n) per-window estimates, all-gathered over ``time`` (the same on
    every rank); they agree with standalone :func:`solve_vmapped` calls
    up to the order of the sums.
    """
    windows = list(windows)
    ref, K = windows[0], len(windows)
    _mesh_axes(mesh, (time_axis, sub_axis))
    kt, ks = int(mesh.shape[time_axis]), int(mesh.shape[sub_axis])
    if K % kt:
        raise ValueError(
            f"window count {K} does not divide over the {kt}-device "
            f"'{time_axis}' mesh axis — pad the stack to a multiple")
    if ref.p % ks:
        raise ValueError(
            f"p={ref.p} subdomains do not divide over the "
            f"{ks}-device '{sub_axis}' mesh axis")
    n, p, w = ref.n, ref.p, ref.w
    Kl, pl = K // kt, p // ks
    t, s = mesh.coords[time_axis], mesh.coords[sub_axis]
    wins, subs = slice(t * Kl, (t + 1) * Kl), slice(s * pl, (s + 1) * pl)
    local = windows[wins]
    for pk in local:
        if _stack_key(pk) != _stack_key(ref) or pk.A_loc.shape[0] != p:
            raise ValueError(
                "solve_window_stack needs whole packings of one shape "
                f"({_stack_key(ref)}); got {_stack_key(pk)} holding "
                f"{pk.A_loc.shape[0]} subdomains")

    def field(name, per_sub=True):
        return torch.stack([getattr(pk, name)[subs] if per_sub
                            else getattr(pk, name) for pk in local])

    scat = np.stack([pk.scatter_cols[subs] for pk in local])
    A, L, mask, muov, wdiv, gath = (field(k) for k in (
        "A_loc", "L_loc", "mask", "muov", "wdiv", "gather_cols"))
    mult, r, b = (field(k, per_sub=False) for k in ("mult", "r", "b"))
    dev, dt = A.device, A.dtype
    # Each window's owner slots over this rank's pl * w local slots, padded
    # with the dump slot pl * w: the local part assembles in a fixed order.
    own = [owner_slots(sc, n) for sc in scat]
    kmax = max(o.shape[1] for o in own)
    own = torch.as_tensor(np.stack([np.pad(
        o, ((0, 0), (0, kmax - o.shape[1])), constant_values=pl * w)
        for o in own]), device=dev).reshape(Kl, -1)
    gath = gath.reshape(Kl, -1)
    n_pad = -(-(n + 1) // ks) * ks

    def assemble_glob(x):
        flat = torch.cat([(x * mask).reshape(Kl, -1),
                          x.new_zeros((Kl, 1))], dim=1)
        got = torch.gather(flat, 1, own).reshape(Kl, n, kmax)
        part = got[..., 0]
        for k in range(1, kmax):
            part = part + got[..., k]
        part = torch.nn.functional.pad(part, (0, n_pad - n))
        glob = mesh.axis_allreduce(part.reshape(-1), sub_axis)
        return glob.reshape(Kl, n_pad)[:, :n] / mult

    def to_local(xg):
        return torch.gather(xg, 1, gath).reshape(Kl, pl, w) * mask

    def step(x):
        Ax = mesh.psum(torch.einsum("kpmw,kpw->km", A, x * wdiv), sub_axis)
        resid = (b[:, None, :] - Ax[:, None, :]
                 + torch.einsum("kpmw,kpw->kpm", A, x))
        rhs = (torch.einsum("kpmw,kpm->kpw", A, r[:, None, :] * resid)
               + muov * x) * mask
        new = _chol_solve(L, rhs) * mask
        return to_local(assemble_glob((1.0 - damping) * x + damping * new))

    x0 = (torch.zeros((K, n), dtype=dt, device=dev) if x0 is None
          else torch.as_tensor(x0, dtype=dt, device=dev))
    x = to_local(x0[wins])
    for _ in range(iters):
        x = step(x)
    return mesh.all_gather(assemble_glob(x), time_axis)


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
