"""The port's DD-KF packing and solve against the JAX package's.

One problem is built in numpy and handed to both packages.  The packing
fields match the reference's (``L_loc`` to 1e-10 as
``tests/test_ddkf_multidevice.py`` holds it; indices and masks exactly).
On one shared packing, ``solve_vmapped`` matches the reference to 1e-13:
the port's "plain" step against the reference's "jnp" step and its
"fused" step against "fused_ref" (on CPU tensors both run plain torch, so
only summation order differs).  ``cls.solve`` matches to 1e-13 and the
DD-KF estimate reaches the direct solve to 1e-8.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cls as j_cls  # noqa: E402
from repro.core import ddkf as j_ddkf  # noqa: E402
from repro.core import domain as j_domain  # noqa: E402
from repro.core import kdtree as j_kdtree  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cls as t_cls  # noqa: E402
from repro_torch.core import ddkf as t_ddkf  # noqa: E402
from repro_torch.core import domain as t_domain  # noqa: E402
from repro_torch.core import kdtree as t_kdtree  # noqa: E402

DATA_FIELDS = ("A_loc", "L_loc", "cols", "mask", "muov", "wdiv", "mult",
               "mult_loc", "scatter_cols", "gather_cols", "r", "b")


def _case(kind: str, overlap: int, seed: int = 0):
    """(problem arrays, reference decomposition, port decomposition) on a
    rebalanced domain of the given kind."""
    rng = np.random.default_rng(seed)
    if kind == "interval":
        jd, td = j_domain.Interval1D(64, 4), t_domain.Interval1D(64, 4)
        obs = np.sort(rng.beta(2, 5, 150))
    else:
        if kind == "shelf":
            jd = j_domain.ShelfTiling2D(nx=12, ny=8, pr=2, pc=2)
            td = t_domain.ShelfTiling2D(nx=12, ny=8, pr=2, pc=2)
        else:
            jd = j_kdtree.KDTreeDomain(nx=12, ny=8, p=4)
            td = t_kdtree.KDTreeDomain(nx=12, ny=8, p=4)
        obs = rng.beta(2, 5, (150, 2))
        obs = obs[np.lexsort((obs[:, 0], obs[:, 1]))]
    jd.rebalance(obs)
    td.rebalance(obs)
    n = jd.n
    H0 = j_cls.state_operator(n)
    H1 = j_cls.observation_operator(n, jd.obs_positions(obs),
                                    block=jd.row_size)
    x_true = rng.normal(size=n)
    y0 = H0 @ x_true + 1e-3 * rng.normal(size=H0.shape[0])
    y1 = H1 @ x_true + 1e-3 * rng.normal(size=H1.shape[0])
    arrs = {"H0": H0, "y0": y0, "H1": H1, "y1": y1,
            "R0": np.ones(H0.shape[0]), "R1": np.ones(H1.shape[0])}
    return (arrs, jd.decomposition(overlap=overlap),
            td.decomposition(overlap=overlap))


def _stacked(arrs):
    return (np.concatenate([arrs["H0"], arrs["H1"]]),
            np.concatenate([arrs["y0"], arrs["y1"]]),
            np.concatenate([arrs["R0"], arrs["R1"]]))


CASES = [(k, s) for k in ("interval", "shelf", "kdtree") for s in (0, 2)]


@pytest.mark.parametrize("kind,overlap", CASES)
def test_pack_operator_matches_reference(kind, overlap):
    arrs, jdec, tdec = _case(kind, overlap)
    A, b, r = _stacked(arrs)
    jp = j_ddkf.pack_operator(jnp.asarray(A), jnp.asarray(r), jdec, mu=0.7,
                              solver_kernel="jnp")
    tp = t_ddkf.pack_operator(A, r, tdec, mu=0.7, device="cpu")
    assert (tp.n, tp.p, tp.w, tp.m) == (jp.n, jp.p, jp.w, jp.m)
    assert tp.solve_kernel == "plain"
    for f in DATA_FIELDS:
        want, got = np.asarray(getattr(jp, f)), np.asarray(getattr(tp, f))
        assert isinstance(getattr(tp, f), np.ndarray) == (
            f in t_ddkf.HOST_FIELDS), f
        assert got.shape == want.shape, f
        if f == "L_loc":
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
        else:
            assert np.array_equal(got, want), f
    # The assembly map is the gather form of the scatter map.
    flat = tp.scatter_cols.reshape(-1)
    owners = tp.owner_slots.numpy()
    for col in range(tp.n):
        slots = owners[col][owners[col] < flat.size]
        assert np.array_equal(slots, np.flatnonzero(flat == col))


@pytest.mark.parametrize("kind,overlap", CASES)
def test_solve_vmapped_matches_reference(kind, overlap):
    arrs, jdec, _ = _case(kind, overlap, seed=1)
    A, b, r = _stacked(arrs)
    jp = j_ddkf.with_rhs(j_ddkf.pack_operator(
        jnp.asarray(A), jnp.asarray(r), jdec, solver_kernel="jnp"),
        jnp.asarray(b))
    fields = {f: np.asarray(getattr(jp, f)) for f in DATA_FIELDS}
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=jp.n)
    # Each kernel pair meets each option once across overlap 0 and 2
    # (every call is a fresh JAX compile, so the grid is not crossed).
    kernels = [("jnp", "plain"), ("fused_ref", "fused")]
    if overlap:
        kernels.reverse()
    for (j_kern, t_kern), (damping, hist, warm) in zip(
            kernels, ((1.0, False, None), (0.7, True, x0))):
        jpk = dataclasses.replace(jp, solve_kernel=j_kern)
        tpk = convert.packed_from_numpy(
            fields, {"n": jp.n, "p": jp.p, "w": jp.w,
                     "solve_kernel": j_kern}, device="cpu")
        assert tpk.solve_kernel == t_kern
        kw = dict(iters=60, damping=damping, residual_history=hist)
        want = j_ddkf.solve_vmapped(
            jpk, x0=None if warm is None else jnp.asarray(warm), **kw)
        got = t_ddkf.solve_vmapped(tpk, x0=warm, **kw)
        if hist:
            (want, want_h), (got, got_h) = want, got
            assert got_h.shape == (60,)
            np.testing.assert_allclose(got_h.numpy(),
                                       np.asarray(want_h), rtol=0,
                                       atol=1e-13)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-13)


def test_cls_solve_and_ddkf_match_direct():
    arrs, _, tdec = _case("interval", 2, seed=3)
    jprob = j_cls.CLSProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tprob = convert.cls_problem_from_numpy(arrs, device="cpu")
    direct = t_cls.solve(tprob)
    np.testing.assert_allclose(direct.numpy(),
                               np.asarray(j_cls.solve(jprob)), rtol=0,
                               atol=1e-13)
    for kernel in ("plain", "fused"):
        x = t_ddkf.solve_vmapped(
            t_ddkf.pack(tprob, tdec, solver_kernel=kernel), iters=150)
        assert float(torch.linalg.norm(x - direct)) < 1e-8
    obs = np.sort(np.random.default_rng(4).beta(2, 5, 150))
    x, res, dec = t_ddkf.ddkf_with_dydd(tprob, obs, 4, overlap=1, iters=150)
    assert dec.p == 4 and res.loads_final.sum() == 150
    assert float(torch.linalg.norm(x - direct)) < 1e-8


@pytest.mark.parametrize("builder", ["local", "random"])
def test_problem_builders_solve_to_the_normal_equations(builder):
    rng = np.random.default_rng(8)
    if builder == "local":
        prob = t_cls.local_problem(rng, 40, rng.uniform(0, 1, 60),
                                   device="cpu")
    else:
        prob = t_cls.random_problem(rng, 30, 45, 20, device="cpu")
    assert prob.H0.dtype == torch.float64 and prob.n == prob.H0.shape[1]
    x = t_cls.solve(prob)
    resid = t_cls.normal_matrix(prob) @ x - t_cls.normal_rhs(prob)
    assert float(resid.abs().max()) < 1e-10
    bumped = x + 1e-3 * torch.from_numpy(rng.normal(size=prob.n))
    assert float(t_cls.objective(prob, x)) < float(
        t_cls.objective(prob, bumped))


def test_pack_operator_defaults_to_the_card():
    arrs, _, tdec = _case("interval", 0)
    A, _, r = _stacked(arrs)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ddkf.pack_operator(A, r, tdec)
