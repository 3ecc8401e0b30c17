"""The port's Kalman filter and CG solve against the JAX package's.

One CLS problem (the reference's ``random_problem`` at the sizes of
``tests/test_cls_kalman.py``: n = 48, m0 = 64, m1 = 80) is handed to both
packages as numpy arrays; the KF steps take inputs drawn with numpy.

Tolerances:
* between the packages, 1e-12 max-abs in f64: the same arithmetic, with
  summation orders that differ by package (measured: at most 3.4e-15 for
  the KF, 3.1e-14 for CG, whose iterates amplify the rounding of ~20
  matrix-vector products);
* against the port's direct ``cls.solve``, the reference's own bounds:
  1e-9 in norm for the KF, 1e-8 max-abs for CG.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cls as j_cls  # noqa: E402
from repro.core import kalman as j_kalman  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cls as t_cls  # noqa: E402
from repro_torch.core import kalman as t_kalman  # noqa: E402

ATOL = 1e-12
FIELDS = ("H0", "y0", "H1", "y1", "R0", "R1")


@pytest.fixture(scope="module")
def probs():
    jp = j_cls.random_problem(jax.random.PRNGKey(0), n=48, m0=64, m1=80)
    tp = convert.cls_problem_from_numpy(
        {k: np.array(getattr(jp, k)) for k in FIELDS}, device="cpu")
    return jp, tp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_solve_cg_matches_reference_and_direct(probs):
    jp, tp = probs
    x = t_cls.solve_cg(tp)
    _close(x, j_cls.solve_cg(jp))
    _close(x, t_cls.solve(tp).numpy(), atol=1e-8)


def test_solve_cg_warm_start_and_iteration_cap(probs):
    """``x0`` starts the iteration (from the solution it stops at once);
    ``maxiter`` caps it, as in the reference."""
    jp, tp = probs
    x_direct = t_cls.solve(tp)
    assert torch.equal(t_cls.solve_cg(tp, x0=x_direct), x_direct)
    for maxiter in (0, 3):
        _close(t_cls.solve_cg(tp, maxiter=maxiter),
               j_cls.solve_cg(jp, maxiter=maxiter))
    x0 = np.random.default_rng(1).normal(size=tp.n)
    _close(t_cls.solve_cg(tp, x0=torch.as_tensor(x0), tol=1e-6),
           j_cls.solve_cg(jp, x0=jnp.asarray(x0), tol=1e-6))


def _kf_inputs(n=8, m=5, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    return {"x": rng.normal(size=n), "P": G @ G.T / n + np.eye(n),
            "M": 0.9 * np.eye(n) + 0.05 * rng.normal(size=(n, n)),
            "Q": 0.01 * np.eye(n), "H": rng.normal(size=(m, n)) / n,
            "y": rng.normal(size=m), "R": rng.uniform(0.5, 2.0, m)}


def test_predict_and_correct_match_reference():
    a = _kf_inputs()
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    js = j_kalman.predict(j_kalman.KFState(x=j["x"], P=j["P"]), j["M"],
                          j["Q"])
    ts = t_kalman.predict(t_kalman.KFState(x=t["x"], P=t["P"]), t["M"],
                          t["Q"])
    _close(ts.x, js.x)
    _close(ts.P, js.P)
    js = j_kalman.correct(js, j["H"], j["y"], j["R"])
    ts = t_kalman.correct(ts, t["H"], t["y"], t["R"])
    _close(ts.x, js.x)
    _close(ts.P, js.P)
    # The covariance stays symmetric, as the reference test asserts.
    _close(ts.P, ts.P.T.numpy(), atol=1e-10)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ts.x = ts.x


def test_run_matches_reference():
    n, m, r = 6, 4, 5
    rng = np.random.default_rng(1)
    arrs = {"Ms": np.stack([0.95 * np.eye(n)] * r),
            "Qs": np.stack([0.01 * np.eye(n)] * r),
            "Hs": rng.normal(size=(r, m, n)), "ys": rng.normal(size=(r, m)),
            "Rs": rng.uniform(0.5, 2.0, (r, m))}
    x0, P0 = np.zeros(n), np.eye(n)
    jf, jxs = j_kalman.run(jnp.asarray(x0), jnp.asarray(P0),
                           **{k: jnp.asarray(v) for k, v in arrs.items()})
    tf, txs = t_kalman.run(torch.as_tensor(x0), torch.as_tensor(P0),
                           **{k: torch.as_tensor(v) for k, v in arrs.items()})
    assert txs.shape == (r, n)
    _close(txs, jxs)
    _close(tf.x, jf.x)
    _close(tf.P, jf.P)


@pytest.mark.parametrize("block", [1, 8])
def test_solve_cls_sequential_matches_reference_and_direct(probs, block):
    """The paper's KF-on-CLS reference: sequential assimilation of the
    observation rows reaches the CLS solution (error ~ 1e-11, §6)."""
    jp, tp = probs
    x = t_kalman.solve_cls_sequential(tp, block=block)
    _close(x, j_kalman.solve_cls_sequential(jp, block=block))
    assert float(torch.linalg.norm(x - t_cls.solve(tp))) < 1e-9


def test_info_init_matches_reference(probs):
    jp, tp = probs
    js, ts = j_kalman._info_init(jp), t_kalman._info_init(tp)
    _close(ts.x, js.x)
    _close(ts.P, js.P)


def test_solve_cls_sequential_needs_whole_blocks(probs):
    _, tp = probs
    with pytest.raises(AssertionError):
        t_kalman.solve_cls_sequential(tp, block=7)
