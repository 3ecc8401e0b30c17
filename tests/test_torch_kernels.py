"""The port's plain kernel versions against the JAX package's.

Inputs are made once with numpy and fed to both packages.  f64: the
plain PyTorch versions against ``repro.kernels.ref`` at 1e-13 max-abs
(same arithmetic, different summation order).  f32: against the Pallas
kernels run in interpret mode at rtol 1e-5, with an absolute floor of
1e-5 of the output's scale for entries that are sums with cancellation.
Shapes cover a ragged m (a multiple of no tile), w = 1 and zero-padded
columns.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (p, m, w, trailing zero-padded columns)
SHAPES = [(3, 301, 37, 0), (2, 129, 1, 0), (4, 200, 64, 11)]


def _inputs(p, m, w, pad, dtype, seed=0):
    rng = np.random.default_rng(seed)
    # Scaled so every output is O(1) and 1e-13 is a relative bound too.
    A = rng.normal(size=(p, m, w)) / np.sqrt(m)
    mask = np.ones((p, w))
    if pad:
        A[:, :, w - pad:] = 0.0
        mask[:, w - pad:] = 0.0
    arrs = {
        "A": A, "r": rng.uniform(0.5, 2.0, size=m),
        "b": rng.normal(size=m), "Ax": rng.normal(size=m),
        "u": rng.normal(size=(p, m)), "x": rng.normal(size=(p, w)),
        "wdiv": rng.uniform(0.3, 1.0, size=(p, w)) * mask,
        "muov": rng.uniform(0.0, 1.0, size=(p, w)) * mask, "mask": mask,
    }
    arrs["rp"] = np.broadcast_to(arrs["r"], (p, m)).copy()
    return {k: v.astype(dtype) for k, v in arrs.items()}


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def _args(d, names):
    t, j = zip(*(_both(d[k]) for k in names))
    return t, j


GRAM = ("A", "rp")
FWD = ("A", "x", "wdiv")
BWD = ("A", "r", "b", "Ax", "u", "x", "muov", "mask")


def _outs(res):
    return res if isinstance(res, tuple) else (res,)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel,names", [
    ("gram", GRAM), ("schwarz_fwd", FWD), ("schwarz_bwd", BWD)])
def test_plain_matches_jax_ref_f64(shape, kernel, names):
    d = _inputs(*shape, np.float64)
    t, j = _args(d, names)
    plain = {"gram": tref.gram_plain, "schwarz_fwd": tref.schwarz_fwd_plain,
             "schwarz_bwd": tref.schwarz_bwd_plain}[kernel]
    ref = {"gram": jref.gram_ref, "schwarz_fwd": jref.schwarz_fwd_ref,
           "schwarz_bwd": jref.schwarz_bwd_ref}[kernel]
    for got, want in zip(_outs(plain(*t)), _outs(ref(*j))):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-13)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel,names", [
    ("gram", GRAM), ("schwarz_fwd", FWD), ("schwarz_bwd", BWD)])
def test_plain_matches_pallas_interpret_f32(shape, kernel, names):
    d = _inputs(*shape, np.float32, seed=1)
    t, j = _args(d, names)
    got = _outs(getattr(tops, kernel)(*t, mode="plain"))
    want = _outs(getattr(jops, kernel)(*j, mode="interpret", block_m=128))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_ops_dispatch_on_cpu_is_the_plain_version():
    d = _inputs(2, 50, 9, 2, np.float64, seed=2)
    t, _ = _args(d, BWD)
    for kernel, names in (("gram", GRAM), ("schwarz_fwd", FWD),
                          ("schwarz_bwd", BWD)):
        args, _ = _args(d, names)
        for a, b in zip(_outs(getattr(tops, kernel)(*args)),
                        _outs(getattr(tops, kernel)(*args, mode="plain"))):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        tops.gram(*_args(d, GRAM)[0], mode="kernel")
    before = tops.launch_counts()
    tops.schwarz_bwd(*t)
    assert tops.launch_counts() == before
