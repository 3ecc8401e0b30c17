"""The port's SSD scan and Mamba-2 block against the JAX package's.

``ssd_scan_plain`` (the plain version of the ``ssd_scan`` CUDA kernel) is
held against ``repro.kernels.ref.ssd_heads_ref`` (the exact one-step
recurrence) and against the Pallas kernel run in interpret mode, at the
shapes and tolerance of ``tests/test_kernels.py`` (atol 5e-5, rtol 5e-4
in f32: the chunked and the sequential algorithms sum in other orders).
Its final state is held against the reference prefill's
``ssd_forward_with_state``; the model-layout ``ssd_ref``, ``apply_ssd``
and ``decode_ssd`` against ``repro.models.ssd`` with the same weights.
Inputs are made with numpy from a seed; step sizes in [0.001, 0.1] and
decay rates in [0.5, 2] keep the state alive across chunks.  The CUDA
kernel itself runs only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as t_ssd  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402

ATOL, RTOL = 5e-5, 5e-4
SHAPES = [(2, 128, 32, 16, 32), (1, 256, 64, 32, 64), (4, 64, 16, 8, 16)]


def _heads(bh, s, p, n, *, groups=None, seed=0):
    """Head-folded inputs x, dt, A, B, C as numpy f32; B and C have
    ``groups`` rows (``bh`` by default)."""
    rng = np.random.default_rng(seed)
    g = bh if groups is None else groups
    return [a.astype(np.float32) for a in (
        rng.normal(size=(bh, s, p)), rng.uniform(0.001, 0.1, (bh, s)),
        -rng.uniform(0.5, 2.0, bh), rng.normal(size=(g, s, n)),
        rng.normal(size=(g, s, n)))]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("bh,s,p,n,chunk", SHAPES)
def test_plain_matches_ref_and_interpret(bh, s, p, n, chunk):
    inputs = _heads(bh, s, p, n)
    got = tops.ssd_scan(*_t(inputs), chunk=chunk, mode="plain")
    assert got.shape == (bh, s, p) and got.dtype == torch.float32
    _close(got, jref.ssd_heads_ref(*_j(inputs), chunk))
    _close(got, jops.ssd_scan(*_j(inputs), chunk=chunk, mode="interpret"))


def test_plain_does_not_depend_on_the_chunk():
    inputs = _t(_heads(2, 128, 16, 8, seed=4))
    ys = [tref.ssd_scan_plain(*inputs, chunk=c, state=True)
          for c in (16, 32, 64, 128, 512)]
    for y, final in ys[1:]:
        _close(y, ys[0][0])
        _close(final, ys[0][1])


@pytest.mark.parametrize("bh,s,p,n,chunk", SHAPES)
def test_final_state_is_the_recurrence_state(bh, s, p, n, chunk):
    """The state after the last chunk is the exact recurrence's state:
    y_t = C_t S_t, so appending one step with dt = 0 and C = e_k reads
    row k of S out of the reference oracle."""
    x, dt, A, B, C = _heads(bh, s, p, n, seed=1)
    _, final = tref.ssd_scan_plain(*_t((x, dt, A, B, C)), chunk=chunk,
                                   state=True)
    assert final.shape == (bh, n, p) and final.dtype == torch.float32
    rows = []
    for k in range(n):
        e = np.zeros((bh, 1, n), np.float32)
        e[:, 0, k] = 1.0
        y = jref.ssd_heads_ref(*_j((
            np.concatenate([x, np.zeros((bh, 1, p), np.float32)], 1),
            np.concatenate([dt, np.zeros((bh, 1), np.float32)], 1), A,
            np.concatenate([B, np.zeros((bh, 1, n), np.float32)], 1),
            np.concatenate([C, e], 1))), chunk)
        rows.append(np.asarray(y)[:, -1])
    _close(final, np.stack(rows, axis=1))


@pytest.mark.parametrize("b,s,nh,g,chunk", [(2, 64, 4, 2, 16),
                                            (1, 40, 4, 1, 40),
                                            (2, 96, 6, 3, 32)])
def test_model_layout_matches_the_reference_prefill_scan(b, s, nh, g,
                                                         chunk):
    """Model-layout ``ssd_ref`` and ``ssd_forward_with_state`` (y and the
    final state) against the reference's, with grouped B and C."""
    hd, n = 16, 8
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, s, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, nh).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    want_y, want_final = jtransformer.ssd_forward_with_state(
        *_j((x, dt, A, B, C)), chunk)
    y, final = tssd.ssd_forward_with_state(*_t((x, dt, A, B, C)), chunk)
    assert final.shape == (b, nh, n, hd)
    _close(y, want_y)
    _close(final, want_final)
    _close(tssd.ssd_ref(*_t((x, dt, A, B, C)), chunk),
           jssd.ssd_ref(*_j((x, dt, A, B, C)), chunk))


@pytest.mark.parametrize("rep", [2, 4])
def test_grouped_bc_equals_the_expanded_form(rep):
    x, dt, A, B, C = _t(_heads(8, 64, 16, 8, groups=8 // rep, seed=3))
    y, final = tref.ssd_scan_plain(x, dt, A, B, C, chunk=16, state=True)
    ye, fe = tref.ssd_scan_plain(x, dt, A, B.repeat_interleave(rep, 0),
                                 C.repeat_interleave(rep, 0), chunk=16,
                                 state=True)
    torch.testing.assert_close(y, ye, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(final, fe, atol=1e-6, rtol=1e-6)


def test_model_like_decays_stay_finite():
    """dt ~ 0.7 and A = -1 (the model's initial weights) send the
    cumulative log-decay of a 256-step chunk to ~-180; the select keeps
    the masked exponents (up to +180, inf in f32) out of the result."""
    rng = np.random.default_rng(5)
    x, _, _, B, C = _heads(2, 512, 16, 8, seed=5)
    dt = rng.uniform(0.5, 0.9, (2, 512)).astype(np.float32)
    A = -np.ones(2, np.float32)
    y, final = tref.ssd_scan_plain(*_t((x, dt, A, B, C)), chunk=256,
                                   state=True)
    assert bool(torch.isfinite(y).all() and torch.isfinite(final).all())
    _close(y, jref.ssd_heads_ref(*_j((x, dt, A, B, C)), 256))


@pytest.fixture(scope="module")
def block():
    cfg_j = jconfigs.get_smoke_config("mamba2-1.3b")
    cfg_t = tconfigs.get_smoke_config("mamba2-1.3b")
    params = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    lp_j = jax.tree.map(lambda a: a[0], params["blocks"]["ssd"])
    # non-zero A_log, dt_bias and norm so each carries weight
    rng = np.random.default_rng(6)
    lp_j = dict(lp_j, **{k: jnp.asarray(rng.normal(size=lp_j[k].shape)
                                        .astype(np.float32) * 0.5)
                         for k in ("A_log", "dt_bias", "norm")})
    lp_t = convert.lm_params_from_numpy(jax.tree.map(np.asarray, lp_j),
                                        device="cpu")
    return cfg_j, cfg_t, lp_j, lp_t


@pytest.mark.parametrize("s", [5, 12, 16, 40])
def test_apply_ssd_matches_reference(block, s):
    """Prompts off the chunk (12) take the padding path."""
    cfg_j, cfg_t, lp_j, lp_t = block
    x = np.random.default_rng(7).normal(size=(2, s, 64)).astype(np.float32)
    got = tssd.apply_ssd(cfg_t, lp_t, torch.from_numpy(x))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jssd.apply_ssd(cfg_j, lp_j, jnp.asarray(x))),
        rtol=0, atol=1e-4)


def test_decode_ssd_matches_reference(block):
    cfg_j, cfg_t, lp_j, lp_t = block
    rng = np.random.default_rng(8)
    cache_j = jssd.init_ssd_cache(cfg_j, 3, jnp.float32)
    cache = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in cache_j.items()}
    cache_t = tssd.init_ssd_cache(cfg_t, 3, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache_t.items()} == \
        {k: v.shape for k, v in cache_j.items()}
    assert cache_t["state"].dtype == torch.float32
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    out_j, new_j = jssd.decode_ssd(cfg_j, lp_j, _j_tree(cache), jnp.asarray(x))
    out_t, new_t = tssd.decode_ssd(cfg_t, lp_t, _t_tree(cache),
                                   torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-4)
    for k in new_j:
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def _j_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_ops_on_cpu_tensors_is_the_plain_version():
    inputs = _t(_heads(4, 64, 16, 8, groups=2))
    before = tops.launch_counts()
    y = tops.ssd_scan(*inputs, chunk=16)
    y2, final = tops.ssd_scan(*inputs, chunk=16, state=True)
    assert tops.launch_counts() == before
    want, want_final = tref.ssd_scan_plain(*inputs, chunk=16, state=True)
    assert torch.equal(y, want) and torch.equal(y2, want)
    assert torch.equal(final, want_final)
    with pytest.raises(ValueError, match="mode"):
        tops.ssd_scan(*inputs, chunk=16, mode="interpret")


@pytest.mark.parametrize("mode", ["auto", "plain"])
def test_a_sequence_off_the_chunk_raises(mode):
    """As the reference's scan: min(chunk, S) must divide S."""
    inputs = _t(_heads(2, 12, 16, 8))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tops.ssd_scan(*inputs, chunk=8, mode=mode)
    assert tops.ssd_scan(*inputs, chunk=16, mode=mode).shape == (2, 12, 16)


def test_cuda_binding_refuses_cpu_tensors_and_other_dtypes():
    x, dt, A, B, C = _t(_heads(2, 64, 16, 8))
    before = t_ssd.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ssd.ssd_scan(x, dt, A, B, C, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        t_ssd.ssd_scan(*(t.double() for t in (x, dt, A, B, C)), chunk=16)
    assert t_ssd.launches == before


# The CUDA kernel runs the four products of the scan (C B^T, the masked
# intra-chunk product, the chunk states and the inter-chunk term) on the
# tensor cores in 3xTF32.  These tests emulate that arithmetic on the
# plain version's algorithm and hold it to the kernel's tolerance against
# the exact f32 result (5e-5 + 5e-4 |plain|, chip_smoke.py's SSD_ATOL and
# SSD_RTOL), with inputs drawn as chip_smoke.ssd_random draws them.

SSD_ALLOWANCE = (5e-5, 5e-4)


def _tf32(t):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add 0x1000 to the bit pattern and
    clear the low 13 bits."""
    bits = t.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(
        ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _mm_tf32(a, b):
    """One TF32 product: both operands rounded, f32 accumulation (the
    products of two TF32 values are exact in f32)."""
    return torch.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a, b):
    """3xTF32: a = hi + lo with hi = tf32(a), lo = tf32(a - hi); the sum
    lo hi + hi lo + hi hi, small terms first, in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah,
                                                                       bh)


def _ssd_products_through(mm, x, dt, A, B, C, chunk):
    """``ref.ssd_scan_plain``'s algorithm with its four products through
    ``mm`` -> (y, final state)."""
    bh, s, p = x.shape
    groups, n = B.shape[0], B.shape[2]
    rep, nc = bh // groups, s // chunk
    xc = x.reshape(groups, rep, nc, chunk, p)
    dtc = dt.reshape(groups, rep, nc, chunk)
    Bc = B.reshape(groups, nc, chunk, n)
    Cc = C.reshape(groups, nc, chunk, n)
    cum = torch.cumsum((dtc * A.reshape(groups, rep, 1, 1)).double(), dim=-1)

    def exp(t):
        return torch.exp(t.float())

    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    L = torch.where(causal, exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    y = mm(mm(Cc, Bc.mT)[:, None] * L * dtc[..., None, :], xc)
    w = exp(cum[..., -1:] - cum) * dtc
    states = mm(Bc.mT[:, None], xc * w[..., None])
    decay = exp(cum[..., -1])
    carry = torch.zeros(groups, rep, n, p)
    before = []
    for c in range(nc):
        before.append(carry)
        carry = decay[..., c, None, None] * carry + states[:, :, c]
    y = y + mm(Cc[:, None], torch.stack(before, dim=2)) * exp(cum)[..., None]
    return y.reshape(bh, s, p), carry.reshape(bh, n, p)


def _over_allowance(got, want):
    atol, rtol = SSD_ALLOWANCE
    return max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
               for g, w in zip(got, want))


def test_tf32_rounding_helper():
    v = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -11, 3.0e-3], dtype=torch.float32)
    got = _tf32(v)
    assert got[:5].tolist() == [1.0, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                                1 + 2 * 2.0 ** -10]
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert (got.numpy().view(np.uint32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("bh,groups,s,p,n,chunk", [(8, 2, 1024, 64, 128, 256),
                                                   (4, 1, 512, 64, 128, 128)])
def test_3xtf32_holds_the_kernel_tolerance_and_single_tf32_does_not(
        bh, groups, s, p, n, chunk):
    """At shapes whose state stays alive across chunks, the emulated
    3xTF32 products stay well inside the allowance in y and the final
    state; one TF32 product each misses it many times over."""
    rng = np.random.default_rng(9)
    args = _t([a.astype(np.float32) for a in (
        rng.normal(size=(bh, s, p)), rng.uniform(0.001, 0.1, (bh, s)),
        -rng.uniform(0.5, 2.0, bh), rng.normal(size=(groups, s, n)),
        rng.normal(size=(groups, s, n)))])
    want = tref.ssd_scan_plain(*args, chunk=chunk, state=True)
    exact = _ssd_products_through(torch.matmul, *args, chunk)
    assert _over_allowance(exact, want) <= 1e-3
    assert _over_allowance(_ssd_products_through(_mm_3xtf32, *args, chunk),
                           want) <= 0.25
    assert _over_allowance(_ssd_products_through(_mm_tf32, *args, chunk),
                           want) > 10


@pytest.mark.parametrize("bh,groups,s,p,n,chunk,a_hi",
                         [(8, 2, 1024, 64, 128, 256, 2.0),
                          (4, 1, 512, 64, 128, 128, 16.0)])
def test_bwd_3xtf32_holds_the_gradient_gate_and_single_tf32_does_not(
        bh, groups, s, p, n, chunk, a_hi):
    """The backward kernel runs every product of ``ssd_scan_bwd_plain``'s
    steps in 3xTF32 (dcum, its cumsum and dA in f64).  Emulated at shapes
    whose state stays alive across chunks, at Mamba-2's step sizes and
    decay rates (A = -exp(A_log), A_log from log U(1, 16)), all five
    gradients stay within chip_smoke.py's f32 gate (1e-4 relative
    Frobenius against autograd through the plain forward) by two decades;
    one TF32 product each misses it (~3e-4 in dx, dB and dC)."""
    rng = np.random.default_rng(9)
    args = _t([a.astype(np.float32) for a in (
        rng.normal(size=(bh, s, p)), rng.uniform(0.001, 0.1, (bh, s)),
        -rng.uniform(0.5, a_hi, bh), rng.normal(size=(groups, s, n)),
        rng.normal(size=(groups, s, n)))])
    dy = torch.from_numpy(rng.normal(size=(bh, s, p)).astype(np.float32))
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(tref.ssd_scan_plain(*leaves, chunk=chunk),
                               leaves, dy)

    def worst(mm):
        got = tref.ssd_scan_bwd_plain(*args, dy, chunk=chunk, matmul=mm)
        return [_rel_frob(g, w) for g, w in zip(got, want)]

    assert max(worst(torch.matmul)) <= 1e-6
    assert max(worst(_mm_3xtf32)) <= 1e-6
    single = worst(_mm_tf32)
    assert max(single) > 1e-4
    assert min(single) > 1e-5


# ---------------------------------------------------------------------------
# The backward (training).  On the CPU ``ops.ssd_scan`` runs the autograd
# Function ``SsdScan`` with the plain forward and the plain backward
# ``ssd_scan_bwd_plain``, written in the steps of the CUDA kernel
# ``csrc/ssd_scan_bwd.cu``.  Its gradients are held to autograd through
# the plain forward (1e-5 relative Frobenius: the same f32 sums in other
# orders) and to ``jax.grad`` of the reference's exact recurrence
# ``ssd_heads_ref`` (1e-4: chunked against sequential).
# ---------------------------------------------------------------------------

GRAD_SHAPES = [(4, 64, 16, 8, 2, 16), (6, 48, 8, 16, 3, 16),
               (2, 40, 16, 8, 2, 40), (4, 32, 8, 8, 1, 8)]


def _rel_frob(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bh,s,p,n,groups,chunk", GRAD_SHAPES)
def test_ssd_scan_function_grads_match_autograd_and_reference(
        bh, s, p, n, groups, chunk):
    inputs = _heads(bh, s, p, n, groups=groups, seed=5)
    dy = np.random.default_rng(6).normal(size=(bh, s, p)).astype(np.float32)
    before = tops.launch_counts()
    leaves = [t.requires_grad_() for t in _t(inputs)]
    got = torch.autograd.grad(tops.ssd_scan(*leaves, chunk=chunk), leaves,
                              torch.from_numpy(dy))
    leaves = [t.requires_grad_() for t in _t(inputs)]
    want = torch.autograd.grad(
        tops.ssd_scan(*leaves, chunk=chunk, mode="plain"), leaves,
        torch.from_numpy(dy))
    assert tops.launch_counts() == before    # the CPU runs no kernel
    rep = bh // groups

    def ref_loss(x, dt, A, B, C):
        y = jref.ssd_heads_ref(x, dt, A, jnp.repeat(B, rep, 0),
                               jnp.repeat(C, rep, 0), chunk)
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(*_j(inputs))
    for g, w, r in zip(got, want, ref):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_frob(g, w) <= 1e-5
        assert _rel_frob(g, r) <= 1e-4


def test_ssd_backward_at_model_like_decays_is_finite():
    """Mamba-2's step sizes and decay rates take cum to about -180 within
    a chunk of 256, where exp(cum_i - cum_j) above the diagonal
    overflows; the selects keep every gradient (and autograd through the
    plain forward) finite and equal."""
    rng = np.random.default_rng(7)
    bh, s, p, n = 2, 512, 8, 8
    x, _, _, B, C = _heads(bh, s, p, n, seed=7)
    dt = rng.uniform(0.3, 0.8, (bh, s)).astype(np.float32)
    A = -rng.uniform(8.0, 12.0, bh).astype(np.float32)
    dy = rng.normal(size=(bh, s, p)).astype(np.float32)
    leaves = [t.requires_grad_() for t in _t((x, dt, A, B, C))]
    got = torch.autograd.grad(tops.ssd_scan(*leaves, chunk=256), leaves,
                              torch.from_numpy(dy))
    leaves = [t.requires_grad_() for t in _t((x, dt, A, B, C))]
    want = torch.autograd.grad(tops.ssd_scan(*leaves, chunk=256,
                                             mode="plain"), leaves,
                               torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all())
        assert _rel_frob(g, w) <= 1e-5


def test_ssd_backward_binding_refuses_cpu_tensors():
    x, dt, A, B, C = _t(_heads(2, 64, 16, 8))
    saved = (torch.zeros(2, 64, dtype=torch.float64),
             torch.zeros(2, 4, 16, 16), torch.zeros(2, 4, 8, 16))
    before = t_ssd.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ssd.ssd_scan_bwd(x, dt, A, B, C, x, saved, chunk=16)
    assert t_ssd.bwd_launches == before


def test_ssd_bwd_workspace_formula():
    # f32: dS (BH, nc, N, P), the head splits' sums of dG (H, BG, nc,
    # chunk, chunk) and parts of dB (H, BG, S, N), ddt's parts (BH, S),
    # ddecay's parts (BH, nc, N P / 256); f64: the row sums of dG .* G per
    # 64-row m tile (BH, S, tiles), the row part of dcum per 64 columns of
    # N (2, BH, S), its column part (BH, S), sum w (x . g) per tile (BH,
    # nc, tiles).  The heads' dB and
    # dC are summed inside the CTAs: no per-head (BH, S, N) dB_h and dC_h
    # (2 x 268 MB at the Mamba-2 1.3B training shape); 120 MB in all.
    bh, groups, s, p, n, chunk = 256, 4, 2048, 64, 128, 256
    nc, tiles = 8, 4
    # four splits of the 64 heads give 4 x 8 x 4 x 4 = 512 >= 264 col CTAs
    assert t_ssd.bwd_splits(bh, groups, s, chunk) == 4
    assert t_ssd.bwd_splits(8, 8, 64, 16) == 1     # rep 1: no split
    assert t_ssd.bwd_splits(6, 2, 48, 16) == 2     # at most rep (3)
    n32, n64 = t_ssd.bwd_workspaces(bh, groups, s, p, n, chunk)
    assert n32 == (bh * nc * n * p + 4 * groups * nc * chunk * chunk
                   + 4 * groups * s * n + bh * s + bh * nc * 32)
    assert n64 == bh * s * tiles + 3 * bh * s + bh * nc * tiles
    assert 4 * n32 < 121e6 and 4 * n32 + 8 * n64 < 160e6
    smem = t_ssd.bwd_smem_bytes()
    assert smem == {"col": 195072, "row": 89600}
    assert max(smem.values()) <= 232448
