"""The port's DD-CLS operators and Schwarz solver against the JAX package's.

The reduction/extension operators (Definitions 3-4) are held bitwise to
the reference on random numpy inputs.  ``SchwarzSolver`` runs on one
spatially-local problem (``tests/test_dd_schwarz.py``'s setting: n = 96,
300 beta-distributed observations), built in numpy and handed to both
packages:
* single multiplicative and additive steps, and whole solves
  (multiplicative, additive, damped, with overlap): at the reference's
  iteration count, the returned iterate and every entry of the
  update-norm history within 1e-12 of the reference's (measured: at
  most 1.8e-15; only summation order differs), and under the port's own
  stopping rule, a count within one of the reference's;
* against the port's direct ``cls.solve`` at the reference's own bounds
  (1e-9, 1e-8 and 1e-7 in norm).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cls as j_cls  # noqa: E402
from repro.core import dd as j_dd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cls as t_cls  # noqa: E402
from repro_torch.core import dd as t_dd  # noqa: E402

ATOL = 1e-12


@pytest.fixture(scope="module")
def probs():
    rng = np.random.default_rng(0)
    obs = rng.beta(2.0, 5.0, 300)
    n = 96
    H0 = t_cls.state_operator(n)
    H1 = t_cls.observation_operator(n, obs)
    x_true = rng.normal(size=n)
    noise = 1e-3 * rng.normal(size=H0.shape[0] + obs.size)
    arrs = {"H0": H0, "y0": H0 @ x_true + noise[:H0.shape[0]], "H1": H1,
            "y1": H1 @ x_true + noise[H0.shape[0]:],
            "R0": np.ones(H0.shape[0]), "R1": np.ones(obs.size)}
    jp = j_cls.CLSProblem(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tp = convert.cls_problem_from_numpy(arrs, device="cpu")
    return jp, tp, t_cls.solve(tp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restrict_and_extend_bitwise(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 64))
    B = rng.normal(size=(n + 3, n))
    w = rng.normal(size=n)
    idx = np.sort(rng.choice(n, size=max(1, n // 3), replace=False))
    jB, tB = jnp.asarray(B), torch.as_tensor(B)
    for fn in ("restrict_cols", "restrict_rows"):
        got = getattr(t_dd, fn)(tB, idx)
        assert np.array_equal(got.numpy(), np.asarray(
            getattr(j_dd, fn)(jB, jnp.asarray(idx)))), fn
    r = t_dd.restrict_vec(torch.as_tensor(w), idx)
    assert np.array_equal(r.numpy(), np.asarray(
        j_dd.restrict_vec(jnp.asarray(w), jnp.asarray(idx))))
    e = t_dd.extend_vec(r, idx, n)
    assert np.array_equal(e.numpy(), np.asarray(j_dd.extend_vec(
        jnp.asarray(r.numpy()), jnp.asarray(idx), n)))
    # Extension then reduction is the identity (Definition 4).
    assert torch.equal(t_dd.restrict_vec(e, torch.as_tensor(idx)), r)


def test_reduction_extension_roundtrip():
    w = torch.arange(1.0, 6.0, dtype=torch.float64)
    e = t_dd.extend_vec(t_dd.restrict_vec(w, [1, 3, 4]), [1, 3, 4], 5)
    assert e.tolist() == [0, 2, 0, 4, 5]


def _solvers(probs, p, overlap, **kw):
    jp, tp, _ = probs
    jdec = j_dd.decompose_1d(96, j_dd.uniform_boundaries(p), overlap=overlap)
    tdec = t_dd.decompose_1d(96, t_dd.uniform_boundaries(p), overlap=overlap)
    return j_dd.SchwarzSolver(jp, jdec, **kw), t_dd.SchwarzSolver(tp, tdec,
                                                                 **kw)


@pytest.mark.parametrize("overlap", [0, 2])
def test_single_steps_match_reference(probs, overlap):
    js, ts = _solvers(probs, 3, overlap, damping=0.8)
    x = np.random.default_rng(3).normal(size=96)
    for step in ("step_multiplicative", "step_additive"):
        got = getattr(ts, step)(torch.as_tensor(x))
        want = getattr(js, step)(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=step)
    for i in range(3):
        np.testing.assert_allclose(ts._L[i].numpy(), np.asarray(js._L[i]),
                                   rtol=0, atol=ATOL)


# (p, overlap, mode, solver kwargs, iters, bound against the direct solve)
SOLVES = {
    "multiplicative_p2": (2, 0, "multiplicative", {}, 200, 1e-9),
    "multiplicative_p4": (4, 0, "multiplicative", {}, 200, 1e-9),
    "additive_p4": (4, 0, "additive", {}, 300, 1e-8),
    "additive_damped_p4": (4, 0, "additive", {"damping": 0.7}, 300, 1e-8),
    "overlap_multiplicative": (3, 2, "multiplicative", {"mu": 1.0}, 300,
                               1e-7),
    "overlap_additive": (3, 2, "additive", {"mu": 1.0}, 300, 1e-7),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_matches_reference_and_direct(probs, case):
    p, overlap, mode, kw, iters, bound = SOLVES[case]
    js, ts = _solvers(probs, p, overlap, **kw)
    jx, jk, jh = js.solve(iters=iters, mode=mode)
    # The same number of steps (tol 0 never stops early): the iterate and
    # every update norm against the reference's.
    tx, tk, th = ts.solve(iters=jk, tol=0.0, mode=mode)
    assert tk == jk and len(th) == len(jh) == tk
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(th, jh, rtol=0, atol=ATOL)
    assert th[-1] < th[0]
    assert float(torch.linalg.norm(tx - probs[2])) < bound
    # Under its own stopping rule the port stops within one step of the
    # reference: the rule compares an update norm with 1e-13 ||x||, where
    # the two packages' last-digit rounding can fall on either side (the
    # overlapping additive case stops at 37 against 36: 1.04347e-12 and
    # 1.04338e-12 against a threshold of 1.04341e-12).
    ox, ok_, oh = ts.solve(iters=iters, mode=mode)
    assert abs(ok_ - jk) <= 1 and ok_ < iters
    np.testing.assert_allclose(oh[:min(ok_, jk)], jh[:min(ok_, jk)],
                               rtol=0, atol=ATOL)
    assert float(torch.linalg.norm(ox - probs[2])) < bound


def test_solve_from_a_warm_start_matches_reference(probs):
    js, ts = _solvers(probs, 4, 0)
    x0 = np.random.default_rng(4).normal(size=96)
    jx, jk, jh = js.solve(x0=jnp.asarray(x0), iters=5, mode="additive")
    tx, tk, th = ts.solve(x0=torch.as_tensor(x0), iters=5, mode="additive")
    assert tk == jk == 5
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(th, jh, rtol=0, atol=ATOL)
