"""The DyDD expert schedule with exact rounding, for the reference's side of
the port's MoE tests.

``repro.core.dydd.schedule_jnp`` rounds each edge's migration
``incidence @ pinv(L) (loads - mean)`` with ``rint`` in floating point.
On the expert ring that migration is often exactly a half-integer (two
tokens on an 8-ring give flows of 1/2; about one random count vector in
five has such an edge), and there the float result lands on either side
of 1/2 depending on the order of the sums: the reference rounds 17 of 400
random 8-ring count vectors differently eagerly and under
``jit(vmap(...))``.  The port computes the migrations exactly
(``repro_torch.core.dydd.schedule_tensor`` with the ring's integer
operators) and rounds half to even.  The whole-model and ``apply_moe``
parity tests run the reference with :func:`exact_schedule_jnp` in place of
``schedule_jnp`` (through :func:`exact_reference_schedule`), so both
packages take the same decision at a tie; ``tests/test_torch_moe.py``
holds the two schedules to each other and to exact rational arithmetic
unpatched, and ``tests/test_torch_train.py`` holds the MoE models' loss
and grads to the unpatched reference on a batch with no tied migration
(:func:`tied_migrations`).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import dydd as jdydd


def ring_numerators(p: int):
    """(M, den, incidence) of the p-ring with M = den pinv(L) integer
    valued, from the reference's numpy graph helpers."""
    edges = jdydd.ring_edges(p)
    den = 12 * p
    M = np.rint(den * np.linalg.pinv(jdydd.laplacian(p, edges)))
    return M, den, jdydd.incidence_matrix(p, edges)


def exact_schedule_jnp(loads, pinvL, incidence):
    """``schedule_jnp`` on the expert ring with exact rounding: the
    numerators incidence @ (M @ loads) are integers below 2^53, exact in
    f64, and num / den is rounded half to even in integer arithmetic.
    ``pinvL`` and ``incidence`` must be the ring's (they may be traced
    under ``lax.scan``, so the ring's are rebuilt from p)."""
    p = loads.shape[-1]
    M, den, inc = ring_numerators(p)
    assert incidence.shape == inc.shape and pinvL.shape == M.shape
    num = jnp.asarray(inc) @ (jnp.asarray(M) @ loads.astype(jnp.float64))
    q = jnp.floor(num / den)
    twice = 2 * (num - q * den)
    up = (twice > den) | ((twice == den) & (jnp.mod(q, 2) == 1))
    return q + up.astype(q.dtype)


def tied_migrations(counts):
    """Which rows of the (..., p) routed-token counts have an edge whose
    exact migration on the p-ring is a half-integer, in integer
    arithmetic."""
    counts = np.asarray(counts, np.int64)
    M, den, inc = ring_numerators(counts.shape[-1])
    twice = 2 * (counts @ M.astype(np.int64).T @ inc.astype(np.int64).T)
    return ((twice % den == 0) & ((twice // den) % 2 == 1)).any(-1)


@pytest.fixture
def exact_reference_schedule(monkeypatch):
    """Run the reference's MoE with :func:`exact_schedule_jnp`."""
    monkeypatch.setattr(jdydd, "schedule_jnp", exact_schedule_jnp)
