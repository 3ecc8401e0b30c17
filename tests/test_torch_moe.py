"""The port's MoE layer and on-device DyDD schedule against the JAX
package's, on the CPU, in f64 (x64 is on in the tests, as the reference's
own MoE tests run).

* ``schedule_tensor`` against ``schedule_jnp`` and exact rational
  arithmetic on rings of 4, 8 and 64 with random counts: the port's
  migrations are rint of the exact migration (half to even) everywhere;
  the reference's equal them wherever the exact migration is not a
  half-integer, and at a half-integer they are one of its two neighbours
  (the float sums land on either side of 1/2: ``_torch_exact_schedule``).
* ``dydd_target_counts``, ``apply_moe``'s routing (sorted token, slot and
  gate of every assignment) and ``load_balance_stats`` equal the
  reference's run with the exact schedule (``exact_reference_schedule``),
  on OLMoE's smoke config (8 experts, top 2), with a zero router (every
  probability tied), with ``moe_dydd_balance`` off and on Mixtral's
  (4 experts, ``moe_ep`` with 2 virtual experts).
* Outputs: the router's softmax is f32 in both packages, as the
  reference has it, and XLA's and PyTorch's f32 ``exp`` differ in the
  last bit for about a third of the entries, so the gates agree to f32's
  resolution; the f64 outputs are held within 1e-6 relative to their
  largest entry, and within 1e-12 with the zero router, whose gates are
  exactly 1/E in both.  The gradients (every parameter and x) within 1e-6
  relative Frobenius of ``jax.grad``.
* A single expert with top 1 and no balancing equals the dense gated MLP
  (1e-12), and two calls are bitwise equal.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_exact_schedule import exact_reference_schedule  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.core import dydd as jdydd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import dydd as tdydd  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402

OUT_RTOL = 1e-6      # f32 gates
EXACT_ATOL = 1e-12   # f64 with exact gates
GRAD_RTOL = 1e-6


def _exact_migrations(counts):
    """rint (half to even) of the exact migrations on the ring, and which
    edges are exact half-integers: pinv(L) of the p-ring has the entries
    (p^2 - 1) / (12 p) - k (p - k) / (2 p), k the ring distance."""
    p = len(counts)
    edges = jdydd.ring_edges(p)
    if p == 2:
        pinv = [[Fraction(1, 4), Fraction(-1, 4)],
                [Fraction(-1, 4), Fraction(1, 4)]]
    else:
        pinv = [[Fraction(p * p - 1, 12 * p)
                 - Fraction(min(abs(i - j), p - abs(i - j))
                            * (p - min(abs(i - j), p - abs(i - j))), 2 * p)
                 for j in range(p)] for i in range(p)]
    mean = Fraction(int(sum(counts)), p)
    b = [Fraction(int(c)) - mean for c in counts]
    lam = [sum(pinv[i][j] * b[j] for j in range(p)) for i in range(p)]
    flows = [lam[i] - lam[j] for i, j in edges]
    ties = np.array([(2 * f).denominator == 1 and (2 * f).numerator % 2 == 1
                     for f in flows])
    return np.array([round(f) for f in flows], np.float64), ties


@pytest.mark.parametrize("p", [4, 8, 64])
def test_schedule_matches_reference(p):
    ops = tdydd.ring_operators(p)
    pinv = np.linalg.pinv(jdydd.laplacian(p, jdydd.ring_edges(p)))
    inc_np = jdydd.incidence_matrix(p, jdydd.ring_edges(p))
    rng = np.random.default_rng(p)
    counts = rng.integers(0, 200, (24, p)).astype(np.float64)
    counts[0] = 0.0
    counts[1, :2] = 1.0                      # two tokens: a tie at p = 8
    got = tdydd.schedule_tensor(torch.from_numpy(counts), ops)
    n_ties = 0
    for row, c in enumerate(counts):
        exact, ties = _exact_migrations(c)
        n_ties += int(ties.any())
        np.testing.assert_array_equal(got[row].numpy(), exact)
        ref = np.asarray(jdydd.schedule_jnp(jnp.asarray(c), jnp.asarray(pinv),
                                            jnp.asarray(inc_np)))
        np.testing.assert_array_equal(ref[~ties], exact[~ties])
        assert np.all(np.abs(ref[ties] - exact[ties]) <= 1)
    assert n_ties > 0 or p != 8
    assert tdydd.ring_operators(p) is ops    # built once a (p, device)


def _cfg(arch="olmoe_1b_7b", **over):
    cj = jconfigs.get_smoke_config(arch)
    ct = tconfigs.get_smoke_config(arch)
    if over:
        cj = dataclasses.replace(cj, **over)
        ct = dataclasses.replace(ct, **over)
    return cj, ct


def _params(cfg_j, zero_router=False, seed=0):
    b = jnn.Builder("init", key=jax.random.PRNGKey(seed), dtype=jnp.float64)
    pj = jmoe.make_moe_params(b, cfg_j)
    if zero_router:
        pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return pj, pt


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(
        scale=0.5, size=(b, s, cfg.d_model))


class _KeepVmap:
    """``jax`` for the reference's moe module, keeping the outputs of each
    ``vmap``-ed call: the first is ``one_row``'s (dispatch, routing)."""

    def __init__(self, store):
        self.store = store

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*a):
            out = mapped(*a)
            self.store.append(out)
            return out
        return run


CASES = {
    "olmoe": ("olmoe_1b_7b", {}, False),
    "zero_router": ("olmoe_1b_7b", {}, True),
    "balance_off": ("olmoe_1b_7b", {"moe_dydd_balance": False}, False),
    "skewed_cf1": ("olmoe_1b_7b", {"capacity_factor": 1.0}, False),
    "mixtral_virtual": ("mixtral_8x22b", {}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case, monkeypatch,
                                     exact_reference_schedule):
    arch, over, zero = CASES[case]
    cj, ct = _cfg(arch, **over)
    pj, pt = _params(cj, zero_router=zero)
    if case == "skewed_cf1":                 # the router leans to expert 0
        r = np.array(pj["router"])
        r[:, 0] += 2.0
        pj = dict(pj, router=jnp.asarray(r))
        pt = dict(pt, router=torch.from_numpy(r))
    x = _x(cj, 3, 40)
    kept = []
    monkeypatch.setattr(jmoe, "jax", _KeepVmap(kept))
    want = np.asarray(jmoe.apply_moe(cj, pj, jnp.asarray(x)))
    ref_tok, ref_slot, ref_gate = (np.asarray(a) for a in kept[0][1])
    xt = torch.from_numpy(x)
    got = tmoe.apply_moe(ct, pt, xt)
    tok, slot, gate = tmoe._dispatch(ct, pt, xt)[1][:3]
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_array_equal(slot.numpy(), ref_slot)
    assert gate.dtype == torch.float32
    np.testing.assert_allclose(gate.numpy(), ref_gate, rtol=1e-6, atol=0)
    assert got.dtype == torch.float64 and got.shape == x.shape
    scale = np.abs(want).max()
    if zero:
        np.testing.assert_array_equal(gate.numpy(), ref_gate)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=EXACT_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=OUT_RTOL * scale)
    assert torch.equal(got, tmoe.apply_moe(ct, pt, xt))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
def test_dydd_target_counts_and_stats_match_reference(
        arch, exact_reference_schedule):
    cj, ct = _cfg(arch)
    e = cj.num_experts
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 60, (16, e))
    counts[0] = 0
    counts[1, :2] = 1
    pinv, inc, _ = jmoe._ring_operators(e)
    ops = tdydd.ring_operators(e)
    for cap in (8, 20, 1000):
        want = np.stack([np.asarray(jmoe.dydd_target_counts(
            jnp.asarray(c, jnp.int32), pinv, inc, cap)) for c in counts])
        got = tmoe.dydd_target_counts(torch.from_numpy(counts), ops, cap)
        np.testing.assert_array_equal(got.numpy(), want)
    pj, pt = _params(cj)
    x = _x(cj, 4, 32, seed=2)
    for over in ({}, {"moe_dydd_balance": False}):
        cj2, ct2 = (dataclasses.replace(c, **over) for c in (cj, ct))
        want = jmoe.load_balance_stats(cj2, pj, jnp.asarray(x))
        got = tmoe.load_balance_stats(ct2, pt, torch.from_numpy(x))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
def test_moe_grads_match_reference(arch, exact_reference_schedule):
    cj, ct = _cfg(arch)
    pj, pt = _params(cj)
    x = _x(cj, 2, 24, seed=3)
    gj = jax.grad(lambda p, xx: jnp.sum(jmoe.apply_moe(cj, p, xx) ** 2),
                  argnums=(0, 1))(pj, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tmoe.apply_moe(ct, leaves, xt) ** 2).sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    want = [gj[0][k] for k in leaves] + [gj[1]]
    for name, g, w in zip([*leaves, "x"], grads, want):
        w = np.asarray(w)
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= GRAD_RTOL, (name, rel)


def test_single_expert_is_the_dense_mlp():
    cj, ct = _cfg(num_experts=1, experts_per_token=1,
                  moe_dydd_balance=False, capacity_factor=1.0)
    pj, pt = _params(cj)
    x = torch.from_numpy(_x(cj, 2, 8, seed=4))
    got = tmoe.apply_moe(ct, pt, x)
    mlp = {"w_up": pt["w_up"][0], "w_gate": pt["w_gate"][0],
           "w_down": pt["w_down"][0]}
    want = tnn.apply_mlp(mlp, x, ct.act, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=EXACT_ATOL)
    ref = jmoe.apply_moe(cj, pj, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=EXACT_ATOL)


def test_param_tree_and_capacity_match_reference():
    for arch in ("olmoe_1b_7b", "mixtral_8x22b"):
        cj, ct = _cfg(arch)
        shapes = jmoe.make_moe_params(jnn.Builder("shape"), cj)
        got = tmoe.make_moe_params(
            tnn.Builder(torch.Generator().manual_seed(0), "cpu",
                        torch.float32), ct)
        assert sorted(got) == sorted(shapes)
        for k, s in shapes.items():
            assert tuple(got[k].shape) == tuple(s.shape), (arch, k)
        for S in (1, 7, 32, 4096):
            cap = int(np.ceil(S * cj.experts_per_token / cj.num_experts
                              * cj.capacity_factor))
            assert tmoe.capacity(ct, S) == max(8, min(cap, S))
    assert tmoe.capacity(tconfigs.get_config("olmoe-1b-7b"), 1) == 8
