"""The port's plain LM kernel versions against the JAX package's.

``attention_plain`` and ``rglru_scan_plain`` (the plain versions of the
``flash_attention`` and ``rglru_scan`` CUDA kernels) are held against
``repro.kernels.ref`` and against the Pallas kernels run in interpret
mode, on inputs made once with numpy, at the shapes and tolerances of
``tests/test_kernels.py``: 2e-5 (atol and rtol) in f32, 2e-2 in bf16.
bf16 inputs are the same f32 numbers rounded to bf16 by each package.
The port's attention also takes k and v with fewer rows than q (grouped
kv heads, read in place); the JAX package gets the same arrays
expanded.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rglru_scan as t_rg  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(x, dtype):
    """One numpy array as a torch tensor and a jax array of ``dtype``."""
    return (torch.from_numpy(x).to(T_DTYPE[dtype]),
            jnp.asarray(x).astype(J_DTYPE[dtype]))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d", [(1, 128, 32), (2, 256, 64),
                                    (3, 192, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_attention_plain_matches_ref_and_interpret(bh, s, d, dtype, causal,
                                                   window):
    rng = np.random.default_rng(0)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.normal(size=(bh, s, d)).astype(np.float32), dtype)
        for _ in range(3))
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window,
                               mode="plain")
    assert got.dtype == T_DTYPE[dtype] and got.shape == (bh, s, d)
    _close(got, jref.attention_ref(qj, kj, vj, causal=causal,
                                   window=window), dtype)
    _close(got, jops.flash_attention(qj, kj, vj, causal=causal,
                                     window=window, mode="interpret",
                                     block_q=64, block_k=64), dtype)


@pytest.mark.parametrize("window", [1, 3])
def test_attention_plain_rows_masked_within_blocks(window):
    """Windows narrower than a block leave most rows of a (q, kv) block
    pair with no visible key: the kernel's p = 0 guard must keep them at
    0.  window = 1 sees only the diagonal, so the output is v itself."""
    rng = np.random.default_rng(1)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.normal(size=(2, 100, 32)).astype(np.float32), "float32")
        for _ in range(3))
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(got, jops.flash_attention(qj, kj, vj, causal=True, window=window,
                                     mode="interpret", block_q=32,
                                     block_k=64), "float32")
    _close(got, jref.attention_ref(qj, kj, vj, causal=True, window=window),
           "float32")
    if window == 1:
        assert torch.equal(got, vt)


def test_attention_plain_nonuniform_blocks():
    """S = 160 is a multiple of neither block: the ragged last blocks are
    masked (as ``tests/test_kernels.py`` checks the Pallas kernel)."""
    q = np.random.default_rng(2).normal(size=(2, 160, 64)).astype(np.float32)
    qt, qj = _both(q, "float32")
    got = tops.flash_attention(qt, qt, qt, causal=True)
    _close(got, jops.flash_attention(qj, qj, qj, causal=True,
                                     mode="interpret", block_q=32,
                                     block_k=64), "float32")
    _close(got, jref.attention_ref(qj, qj, qj, causal=True), "float32")


@pytest.mark.parametrize("bh,bh_kv", [(8, 8), (8, 2), (32, 2), (16, 1)])
@pytest.mark.parametrize("s", [40, 130])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_attention_grouped_kv_matches_ref_and_interpret(bh, bh_kv, s, d,
                                                        causal, window):
    """k and v with BH_kv rows, row bh // (BH / BH_kv) serving query row
    bh: the port on grouped k, v against the JAX package on the same
    arrays expanded with np.repeat (repeat_interleave's order), and
    bitwise equal to the plain version on the expanded tensors."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(bh, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(bh_kv, s, d)).astype(np.float32)
            for _ in range(2))
    rep = bh // bh_kv
    (qt, qj), (kt, _), (vt, _) = (_both(x, "float32") for x in (q, k, v))
    (ket, kej), (vet, vej) = (_both(np.repeat(x, rep, axis=0), "float32")
                              for x in (k, v))
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.shape == (bh, s, d)
    _close(got, jref.attention_ref(qj, kej, vej, causal=causal,
                                   window=window), "float32")
    _close(got, jops.flash_attention(qj, kej, vej, causal=causal,
                                     window=window, mode="interpret",
                                     block_q=64, block_k=64), "float32")
    assert torch.equal(got, tref.attention_plain(qt, ket, vet, causal=causal,
                                                 window=window))


@pytest.mark.parametrize("q_shape,k_shape,v_shape", [
    ((6, 40, 16), (4, 40, 16), (4, 40, 16)),    # BH_kv does not divide BH
    ((6, 40, 16), (3, 41, 16), (3, 41, 16)),    # S differs
    ((6, 40, 16), (3, 40, 8), (3, 40, 8)),      # D differs
    ((6, 40, 16), (3, 40, 16), (2, 40, 16)),    # v's rows differ from k's
])
def test_attention_kv_shape_checks(q_shape, k_shape, v_shape):
    """The CPU path (plain version) and the wrapper's launch plan refuse
    k, v that cannot serve q."""
    q, k, v = (torch.zeros(sh) for sh in (q_shape, k_shape, v_shape))
    with pytest.raises(ValueError, match="attention_plain"):
        tops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="flash_attention"):
        t_fa.launch_plan(q_shape, k_shape, v_shape, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_launch_plan_fits_one_cta(dtype):
    """Every head dimension the kernels take fits the card's 227 KB of
    shared memory a CTA; bf16 runs CTAs of three warpgroups (384 threads)
    on 128 q rows: at head dimension 64 and 128 with 128-row kv tiles on
    three stages, one persistent CTA an SM; at 256
    with 64-row kv tiles, one CTA a q block and head; f32 one CTA of 8
    warps (256 threads) on 64 q rows with 32-row kv tiles in pairs, head
    dimension padded to 64, 128 or 256."""
    seen = set()
    for d in range(8, t_fa.MAX_HEAD_DIM + 1, 8):
        kv = (4, 4096, d)
        plan = t_fa.launch_plan((64, 4096, d), kv, kv, T_DTYPE[dtype])
        assert plan["smem_bytes"] <= t_fa.MAX_SMEM == 232448
        assert plan["dp"] >= d and plan["rep"] == 16
        seen.add(plan["dp"])
        assert plan["items"] == 64 * 4096 // plan["bq"]
        if dtype == "bfloat16" and plan["dp"] <= 128:
            assert (plan["threads"], plan["bq"], plan["bk"],
                    plan["stages"]) == (384, 128, 128, 3)
            assert plan["persistent"] and plan["ctas"] == 132
            if plan["dp"] == 128:
                # q at 2 x 64 rows, three stages of 128-row k and v tiles:
                # 32 + 192 KB, the padding, 14 mbarriers and the q tiles'
                # work item
                assert plan["smem_bytes"] == 1024 + 224 * 1024 + 112 + 16
        elif dtype == "bfloat16":
            assert (plan["threads"], plan["bq"], plan["bk"],
                    plan["stages"]) == (384, 128, 64, 2)
            assert not plan["persistent"]
            assert plan["ctas"] == 64 * 4096 // 128
        else:
            assert (plan["threads"], plan["bq"], plan["bk"],
                    plan["stages"]) == (256, 64, 32, 2)
            assert plan["ctas"] == 64 * 4096 // 64
            if d == 256:
                # Q at 64 rows, a pair of K and of V tiles at 32, P (64
                # rows of 68), rows of 260 floats
                assert plan["smem_bytes"] == 217088
    assert seen == {64, 128, 256}
    # a head dimension off the multiple of 8 is zero-padded to one, the
    # softmax scale staying the true D's
    plan = t_fa.launch_plan((2, 16, 12), (2, 16, 12), (2, 16, 12),
                            T_DTYPE[dtype])
    assert (plan["d_pad"], plan["dp"]) == (16, 64)
    assert plan["scale"] == 1.0 / math.sqrt(12)
    with pytest.raises(ValueError, match="at most 256"):
        t_fa.launch_plan((2, 16, 264), (2, 16, 264), (2, 16, 264),
                         T_DTYPE[dtype])


@pytest.mark.parametrize("d", [3, 12, 20, 24])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_padded_head_dim_keeps_the_scale(d, dtype):
    """What the wrappers hand the kernels at a head dimension the kernels
    do not read as it is (forward: D off a multiple of 8; bf16 backward:
    off 16): q, k, v (and o, dO) zero-padded to the plan's ``d_pad`` with
    the true D's scale give the unpadded function's output, lse and
    gradients in the first D columns and zeros past them."""
    dt = T_DTYPE[dtype]
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(4, 33, d, generator=gen).to(dt)
                   for _ in range(4))
    k, v = k[:2], v[:2]
    plan = t_fa.launch_plan(q.shape, k.shape, v.shape, dt)
    assert plan["d_pad"] == -(-d // 8) * 8 and plan["d_pad"] % 8 == 0
    kw = dict(causal=True, window=16)
    pad = lambda t, n: t_fa.pad_head_dim(t, n)  # noqa: E731
    out, lse = tref.attention_plain(q, k, v, lse=True, **kw)
    dp = plan["d_pad"]
    out_p, lse_p = tref.attention_plain(pad(q, dp), pad(k, dp), pad(v, dp),
                                        lse=True, scale=plan["scale"], **kw)
    assert torch.equal(lse_p, lse)
    assert torch.equal(out_p[..., :d], out)
    assert not out_p[..., d:].any()
    bplan = t_fa.bwd_plan(q.shape, k.shape, dt)
    assert bplan["d_pad"] == -(-d // (8 if dtype == "float32" else 16)) * (
        8 if dtype == "float32" else 16)
    bp = bplan["d_pad"]
    want = tref.attention_bwd_plain(q, k, v, out, lse, do, **kw)
    got = tref.attention_bwd_plain(*(pad(t, bp) for t in (q, k, v, out)),
                                   lse, pad(do, bp), scale=plan["scale"],
                                   **kw)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for g, w in zip(got, want):
        assert not g[..., d:].float().any()
        np.testing.assert_allclose(g[..., :d].float().numpy(),
                                   w.float().numpy(), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, size=(b, s, w)).astype(np.float32)
    x = (0.1 * rng.normal(size=(b, s, w))).astype(np.float32)
    return a, x


@pytest.mark.parametrize("b,s,w", [(1, 128, 64), (2, 256, 128),
                                   (3, 512, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_plain_matches_ref_and_interpret(b, s, w, dtype):
    a, x = _scan_inputs(b, s, w, seed=3)
    (at, aj), (xt, xj) = _both(a, dtype), _both(x, dtype)
    got = tops.rglru_scan(at, xt, mode="plain")
    assert got.dtype == T_DTYPE[dtype] and got.shape == (b, s, w)
    _close(got, jref.rglru_scan_ref(aj.astype(jnp.float32),
                                    xj.astype(jnp.float32)), dtype)
    _close(got, jops.rglru_scan(aj, xj, mode="interpret", block_s=64,
                                block_w=32), dtype)


@pytest.mark.parametrize("b,s,w", [(2, 1, 33), (3, 77, 100), (1, 40, 1)])
def test_rglru_scan_plain_ragged_shapes(b, s, w):
    """S = 1 and widths that are no multiple of a warp or a lane tile."""
    a, x = _scan_inputs(b, s, w, seed=4)
    (at, aj), (xt, xj) = _both(a, "float32"), _both(x, "float32")
    got = tops.rglru_scan(at, xt)
    _close(got, jref.rglru_scan_ref(aj, xj), "float32")
    _close(got, jops.rglru_scan(aj, xj, mode="interpret",
                                block_s=min(s, 16), block_w=min(w, 32)),
           "float32")


def test_rglru_scan_plain_sequential_semantics():
    a = torch.full((1, 5, 4), 0.5)
    x = torch.ones((1, 5, 4))
    h, want = 0.0, []
    for _ in range(5):
        h = 0.5 * h + 1.0
        want.append(h)
    got = tref.rglru_scan_plain(a, x)
    np.testing.assert_allclose(got[0, :, 0].numpy(), want, rtol=1e-7)


@pytest.mark.parametrize("b,s,w,dtype,path", [
    (2, 4096, 4096, "float32", "tma"), (4, 4096, 4096, "float32", "tma"),
    (3, 77, 100, "float32", "tma"), (1, 1, 4, "float32", "tma"),
    (2, 65, 8, "bfloat16", "tma"), (3, 77, 100, "bfloat16", "direct"),
    (2, 1, 33, "float32", "direct"), (1, 33, 1, "bfloat16", "direct"),
    (2, 1000, 70, "float32", "direct"), (1, 40, 12, "bfloat16", "direct")])
def test_rglru_scan_fwd_plan_path_and_shared_memory(b, s, w, dtype, path):
    """The forward takes the TMA path where a row of W elements is a
    multiple of 16 bytes (W % 4 in f32, W % 8 in bf16), with CTAs of two
    warps on 32 channels of one batch row and 4 stages of 64-step boxes
    within one CTA's 227 KB (two CTAs an SM in f32); the direct path
    otherwise and wherever a tensor is off a 16-byte boundary."""
    plan = t_rg.fwd_plan((b, s, w), T_DTYPE[dtype])
    assert plan["path"] == path
    assert plan["smem_bytes"] <= t_fa.MAX_SMEM
    if path == "tma":
        size = 4 if dtype == "float32" else 2
        assert (plan["threads"], plan["stages"]) == (64, 4)
        assert plan["ctas"] == -(-w // 32) * b
        assert plan["smem_bytes"] == 128 + 32 * 64 * size * 10 + 64
        if dtype == "float32":
            assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
        assert t_rg.fwd_plan((b, s, w), T_DTYPE[dtype],
                             aligned=False)["path"] == "direct"
    else:
        assert plan["smem_bytes"] == 0 and plan["ctas"] == -(-w // 64) * b
    if (b, s, w) == (2, 4096, 4096):
        assert plan["ctas"] == 256 >= 132


# ---------------------------------------------------------------------------
# Dispatch and wrappers.
# ---------------------------------------------------------------------------

def test_ops_dispatch_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 40, 16)).astype(np.float32))
    a, x = (torch.from_numpy(t) for t in _scan_inputs(2, 30, 8, seed=6))
    before = tops.launch_counts()
    assert torch.equal(tops.flash_attention(q, q, q, window=8),
                       tref.attention_plain(q, q, q, window=8))
    assert torch.equal(tops.rglru_scan(a, x), tref.rglru_scan_plain(a, x))
    assert tops.launch_counts() == before
    with pytest.raises(ValueError, match="mode"):
        tops.rglru_scan(a, x, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        tops.flash_attention(q, q, q, mode="interpret")


def test_lm_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 16, 8)
    a = torch.zeros(1, 4, 8)
    before = (t_fa.launches, t_rg.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rg.rglru_scan(a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_rg.rglru_scan(a, a, direct=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_rg.rglru_scan(a.half(), a.half())
    assert (t_fa.launches, t_rg.launches) == before
    counts = tops.launch_counts()
    assert set(counts) == {"gram", "schwarz_fwd", "schwarz_bwd",
                           "flash_attention", "rglru_scan", "ssd_scan",
                           "flash_attention_bwd", "rglru_scan_bwd",
                           "ssd_scan_bwd"}


# ---------------------------------------------------------------------------
# The backward (training).  On CPU tensors ``ops.flash_attention`` and
# ``ops.rglru_scan`` run the autograd Functions ``FlashAttention`` and
# ``RglruScan`` with the plain forward and the plain backward that the
# CUDA kernels evaluate (``ref.attention_bwd_plain``, FA2's formulas from
# the saved log-sum-exp; ``ref.rglru_scan_bwd_plain``, the chunked reverse
# scan).
# Their gradients are held to autograd through the plain forward (1e-5
# relative Frobenius in f32: the same sums in other orders) and to
# ``jax.grad`` of the reference's jnp oracles (1e-4).
# ---------------------------------------------------------------------------

def _rel_frob(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _near_one_key(bh, bh_kv, s, d, causal, window, seed, alpha=1.0):
    """q, k, v, dO (f32, numpy) with each query row ``alpha`` times one
    key row it sees, so that its softmax sits nearly on that key (the
    key's score ~ alpha sqrt(D), the others' ~ alpha N(0, 1)), and V_j ~
    O_i."""
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(bh_kv, s, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(bh, s, d)).astype(np.float32)
    pos = np.arange(s)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros(s, int)
    hi = pos + 1 if causal else np.full(s, s)
    pick = rng.integers(lo, hi, size=(bh, s))
    q = alpha * k[np.arange(bh)[:, None] // (bh // bh_kv), pick]
    return q.astype(np.float32), k, v, do


@pytest.mark.parametrize("inputs", ["random", "near_one_key"])
@pytest.mark.parametrize("bh,bh_kv,s,d,causal,window", [
    (4, 4, 40, 16, True, 0), (8, 2, 64, 32, True, 24),
    (16, 1, 48, 16, True, 16), (4, 2, 33, 16, False, 0),
    (4, 1, 50, 32, False, 20)])
def test_flash_attention_function_grads_match_autograd_and_reference(
        bh, bh_kv, s, d, causal, window, inputs):
    """The CPU backward (``ref.attention_bwd_plain``: dQ from dS = P .*
    dO (V - O)) against autograd through the plain forward and
    ``jax.grad`` of the reference's attention, on random inputs and on
    inputs whose rows sit nearly on one key."""
    if inputs == "random":
        rng = np.random.default_rng(11)
        q = rng.normal(size=(bh, s, d)).astype(np.float32)
        k, v = (rng.normal(size=(bh_kv, s, d)).astype(np.float32)
                for _ in range(2))
        do = rng.normal(size=(bh, s, d)).astype(np.float32)
    else:
        q, k, v, do = _near_one_key(bh, bh_kv, s, d, causal, window, seed=11)
    kw = dict(causal=causal, window=window)
    before = tops.launch_counts()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tops.flash_attention(*leaves, **kw), leaves,
                              torch.from_numpy(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(tops.flash_attention(*leaves, **kw,
                                                    mode="plain"),
                               leaves, torch.from_numpy(do))
    assert tops.launch_counts() == before    # the CPU runs no kernel
    rep = bh // bh_kv

    def ref_loss(q, k, v):
        out = jref.attention_ref(q, jnp.repeat(k, rep, 0),
                                 jnp.repeat(v, rep, 0), **kw)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                  for a in (q, k, v)))
    for g, w, r in zip(got, want, ref):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_frob(g, w) <= 1e-5
        assert _rel_frob(g, r) <= 1e-4


def test_flash_attention_function_saves_the_log_sum_exp():
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 24, 16)).astype(
        np.float32)) for _ in range(3))
    out, lse = tref.attention_plain(q, k, v, causal=True, window=8,
                                    lse=True)
    s = torch.einsum("bqd,bkd->bqk", q, k) / 4.0
    pos = torch.arange(24)
    ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 8)
    want = torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1)
    assert torch.allclose(lse, want, atol=1e-5, rtol=1e-6)
    assert torch.equal(out, tref.attention_plain(q, k, v, causal=True,
                                                 window=8))


def _worst_grad_row(g, plain):
    """``chip_smoke.worst_grad_row``: the largest over rows of ||g -
    plain|| / max(||plain||, 1e-2 median row norm)."""
    rows = plain.double().norm(dim=-1)
    floor = 1e-2 * float(rows.median())
    diff = (g.double() - plain.double()).norm(dim=-1)
    return float((diff / rows.clamp_min(floor)).max())


def _dq_delta_form(q, k, v, o, lse, do, causal, window):
    """dQ by the earlier f32 form, dS = P .* (dO V^T - Delta) with Delta =
    rowsum(dO .* O): the sum over D first, then the difference."""
    rep = q.shape[0] // k.shape[0]
    ke, ve = (t.repeat_interleave(rep, dim=0) for t in (k, v))
    scale = 1.0 / np.sqrt(q.shape[2])
    pos = torch.arange(q.shape[1])
    ok = torch.ones(q.shape[1], q.shape[1], dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    p = torch.where(ok, torch.exp(torch.einsum("bqd,bkd->bqk", q, ke) * scale
                                  - lse[..., None]), 0.0)
    delta = (do * o).sum(-1)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, ve) - delta[..., None])
    return torch.einsum("bqk,bkd->bqd", ds, ke) * scale


@pytest.mark.parametrize("bh,bh_kv,s,d,causal,window", [
    (4, 2, 128, 64, True, 0), (4, 2, 128, 64, True, 32),
    (8, 1, 96, 32, True, 0), (4, 4, 64, 128, True, 16)])
def test_attention_bwd_plain_dq_holds_rows_near_one_key(bh, bh_kv, s, d,
                                                        causal, window):
    """Where each row's softmax sits nearly on one key, dP_ij - Delta_i
    cancels in f32: dQ by that form misses the f64 plain backward (on the
    same f32 out and lse) row by row beyond the card's 2e-5 gate, while
    ``attention_bwd_plain``'s dS = P .* dO (V - O) in f32 stays within
    it (dS less its row's P-weighted mean, as the kernel)."""
    q, k, v, do = (torch.from_numpy(a) for a in _near_one_key(
        bh, bh_kv, s, d, causal, window, seed=21))
    kw = dict(causal=causal, window=window)
    o, lse = tref.attention_plain(q, k, v, lse=True, **kw)
    want = tref.attention_bwd_plain(*(t.double() for t in (q, k, v, o, lse,
                                                           do)), **kw)[0]
    got = tref.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    assert _worst_grad_row(got[0], want) <= 2e-5
    assert _worst_grad_row(_dq_delta_form(q, k, v, o, lse, do, **kw),
                           want) > 2e-5


def test_attention_bwd_plain_dq_does_not_follow_the_saved_outs_rounding():
    """dQ subtracts each row's P-weighted mean of dS, 0 in exact
    arithmetic: a saved out perturbed by 1e-6 of itself (the size of an
    f32 forward's rounding against a recomputed P) leaves dQ as it was
    (in f64, to 1e-12 a row), where dS K alone moves by more than 1e-8."""
    rng = np.random.default_rng(23)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh))
                   for sh in ((4, 64, 32), (2, 64, 32), (2, 64, 32),
                              (4, 64, 32)))
    kw = dict(causal=True, window=24)
    o, lse = tref.attention_plain(q, k, v, lse=True, **kw)
    o, lse = o.double(), lse.double()
    o2 = o * (1 + 1e-6 * torch.from_numpy(rng.normal(size=o.shape)))
    dq, dq2 = (tref.attention_bwd_plain(q, k, v, t, lse, do, **kw)[0]
               for t in (o, o2))
    assert _worst_grad_row(dq2, dq) <= 1e-12

    def ds_k(o):
        ke, ve = (t.repeat_interleave(2, dim=0) for t in (k, v))
        pos = torch.arange(64)
        ok = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                               - 24)
        p = torch.where(ok, torch.exp(q @ ke.transpose(1, 2) / np.sqrt(32)
                                      - lse[..., None]), 0.0)
        g = torch.einsum("bqd,bqkd->bqk", do,
                         ve[:, None] - o[:, :, None])
        return (p * g) @ ke / np.sqrt(32)

    assert _worst_grad_row(ds_k(o2), ds_k(o)) > 1e-8


def test_attention_bwd_plain_bf16_dq_is_the_bf16_kernels_form():
    """In bf16 the plain dQ is the bf16 kernel's: dS = P .* (dO V^T -
    Delta) from the saved bf16 out, uncentred (its rounding of O is part
    of the function the bf16 kernel computes); dK and dV as in f32."""
    rng = np.random.default_rng(24)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   .bfloat16() for sh in ((4, 48, 16), (2, 48, 16),
                                          (2, 48, 16), (4, 48, 16)))
    kw = dict(causal=True, window=20)
    o, lse = tref.attention_plain(q, k, v, lse=True, **kw)
    got = tref.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _dq_delta_form(*(t.float() for t in (q, k, v, o)), lse,
                          do.float(), **kw)
    assert torch.equal(got[0], want.bfloat16())
    f32 = tref.attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse,
                                   do.float(), **kw)
    for g, w in zip(got[1:], f32[1:]):
        assert torch.equal(g, w.bfloat16())


def test_attention_bwd_plain_chunks_the_difference(monkeypatch):
    """dO_i . (V_j - O_i) over chunks of a few query rows (the keys each
    chunk may see) is the whole difference at once (to rounding: the
    product's sum order may follow the chunk's shape)."""
    rng = np.random.default_rng(22)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   for sh in ((8, 40, 16), (2, 40, 16), (2, 40, 16),
                              (8, 40, 16)))
    for causal, window in ((True, 0), (True, 12), (False, 0), (False, 9)):
        kw = dict(causal=causal, window=window)
        o, lse = tref.attention_plain(q, k, v, lse=True, **kw)
        whole = tref.attention_bwd_plain(q, k, v, o, lse, do, **kw)
        with monkeypatch.context() as m:
            m.setattr(tref, "ATTN_DIFF_ELEMENTS", 8 * 16 * 3)
            chunked = tref.attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for a, b in zip(whole, chunked):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("b,s,w", [(1, 37, 8), (2, 64, 16)])
def test_rglru_scan_function_grads_match_autograd_and_reference(b, s, w):
    rng = np.random.default_rng(13)
    a = rng.uniform(0.5, 0.99, (b, s, w)).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    dh = rng.normal(size=(b, s, w)).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, x)]
    got = torch.autograd.grad(tops.rglru_scan(*leaves), leaves,
                              torch.from_numpy(dh))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, x)]
    want = torch.autograd.grad(tops.rglru_scan(*leaves, mode="plain"),
                               leaves, torch.from_numpy(dh))
    ref = jax.grad(lambda a, x: jnp.sum(jref.rglru_scan_ref(a, x)
                                        * jnp.asarray(dh)),
                   argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
    for g, wt, r in zip(got, want, ref):
        assert _rel_frob(g, wt) <= 1e-5
        assert _rel_frob(g, r) <= 1e-4


def _rel_or_zero(a, b):
    """Relative Frobenius difference; 0 where both are exactly zero (da
    at S = 1, where h_{-1} = 0)."""
    b64 = np.asarray(b, np.float64)
    if not np.linalg.norm(b64):
        return float(np.linalg.norm(np.asarray(a, np.float64)))
    return _rel_frob(a, b64)


# S a multiple of the chunk, not a multiple, shorter than it, and S = 1;
# at a small chunk (several chunks at CPU sizes) and at the kernel's.
@pytest.mark.parametrize("b,s,w,chunk", [
    (2, 64, 8, 8), (1, 37, 5, 8), (2, 5, 4, 8), (2, 1, 3, 8),
    (2, 128, 6, None), (1, 130, 4, None), (3, 40, 3, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_bwd_plain_chunked_matches_autograd_and_reference(
        b, s, w, chunk, dtype):
    """``ref.rglru_scan_bwd_plain``, the chunked reverse scan the kernel
    runs (chunk, carry, out), against autograd through the sequential
    plain forward (1e-5 in f32, LM_TOL in bf16) and, in f32, ``jax.grad``
    of the reference's jnp oracle (1e-4)."""
    rng = np.random.default_rng(14)
    a = rng.uniform(0.5, 0.99, (b, s, w)).astype(np.float32)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    dh = rng.normal(size=(b, s, w)).astype(np.float32)
    t = T_DTYPE[dtype]
    leaves = [torch.from_numpy(v).to(t).requires_grad_() for v in (a, x)]
    h = tref.rglru_scan_plain(*leaves)
    dht = torch.from_numpy(dh).to(t)
    want = torch.autograd.grad(h, leaves, dht)
    kw = {} if chunk is None else {"chunk": chunk}
    got = tref.rglru_scan_bwd_plain(leaves[0].detach(), h.detach(), dht,
                                    **kw)
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    for g, wt in zip(got, want):
        assert g.shape == (b, s, w) and g.dtype == t
        assert _rel_or_zero(g.float(), wt.float()) <= tol
    if dtype == "float32":
        ref = jax.grad(lambda a, x: jnp.sum(jref.rglru_scan_ref(a, x)
                                            * jnp.asarray(dh)),
                       argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
        for g, r in zip(got, ref):
            assert _rel_or_zero(g, r) <= 1e-4


def test_rglru_scan_bwd_plain_chunk_is_the_kernels():
    """The default chunk is the kernel's (``test_torch_build`` reads it
    from the source); the chunk length moves only the rounding, and a
    chunk of 1 or of S is the plain reverse scan."""
    rng = np.random.default_rng(15)
    a, x, dh = (torch.from_numpy(v.astype(np.float32)) for v in (
        rng.uniform(0.5, 0.99, (2, 100, 3)), rng.normal(size=(2, 100, 3)),
        rng.normal(size=(2, 100, 3))))
    h = tref.rglru_scan_plain(a, x)
    base = tref.rglru_scan_bwd_plain(a, h, dh)
    assert all(torch.equal(u, v) for u, v in zip(
        base, tref.rglru_scan_bwd_plain(a, h, dh, chunk=64)))
    for c in (1, 7, 100, 1000):
        for u, v in zip(tref.rglru_scan_bwd_plain(a, h, dh, chunk=c), base):
            assert _rel_frob(u, v) <= 1e-6
    with pytest.raises(ValueError, match="chunk"):
        tref.rglru_scan_bwd_plain(a, h, dh, chunk=0)


@pytest.mark.parametrize("d", [16, 128, 256])
def test_flash_attention_bwd_plan_f32_fits_one_cta(d):
    """The f32 backward's launches fit one CTA's 227 KB of shared memory
    at the smoke head dimension, 128 and the training shape's 256: dq on
    48 q rows (Q, dO and O staged) with 16-row kv tiles in pairs, dkdv on
    32 kv rows with
    32-row q tiles in pairs; one kv head per 16 query
    heads splits into two query-head groups (a cluster of two CTAs a kv
    block), since 128 kv blocks of 2 kv heads alone would leave the 132
    SMs ragged."""
    plan = t_fa.bwd_plan((32, 4096, d), (2, 4096, d), torch.float32)
    assert plan["dq_smem_bytes"] <= t_fa.MAX_SMEM
    assert plan["dkdv_smem_bytes"] <= t_fa.MAX_SMEM
    assert (plan["bq"], plan["bk"], plan["bkv"], plan["bqt"],
            plan["stages"], plan["groups"]) == (48, 16, 32, 32, 2, 2)
    assert plan["dp"] >= d and plan["threads"] == 256
    assert plan["dq_ctas"] == 86 * 32 and plan["dkdv_ctas"] == 128 * 2 * 2
    assert plan["ws_shape"] == (32, 4096)
    if d == 256:
        # K, V at 32 rows, a pair of Q, dO (32 rows), lse and Delta, P^T
        # and dS^T (32 rows of 68), rows of 260 floats
        assert plan["dkdv_smem_bytes"] == 217600
        # Q, dO and O at 48 rows, a pair of K and of V tiles (16 rows), P
        # and dS (48 rows of 36 each)
        assert plan["dq_smem_bytes"] == 230144
    # one query head per kv head, or kv blocks enough for two waves: one
    # group
    for q_shape, k_shape in (((4, 4096, d), (4, 4096, d)),
                             ((32, 16384, d), (2, 16384, d))):
        small = t_fa.bwd_plan(q_shape, k_shape, torch.float32)
        assert small["groups"] == 1
        assert small["dkdv_ctas"] == -(-q_shape[1] // 32) * k_shape[0]


def test_flash_attention_bwd_f32_refuses_cpu_tensors_and_mixed_dtypes():
    q = torch.zeros(2, 16, 8)
    lse = torch.zeros(2, 16)
    before = t_fa.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(TypeError, match="expected torch.float32"):
        t_fa.flash_attention_bwd(q, q.bfloat16(), q, q, lse, q)
    with pytest.raises(TypeError, match="expected torch.float32"):
        t_fa.flash_attention_bwd(q, q, q, q, lse, q.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.flash_attention_bwd(*(t.double() for t in (q, q, q, q)), lse,
                                 q.double())
    assert t_fa.bwd_launches == before


def test_flash_attention_f32_refuses_cpu_tensors_and_mixed_dtypes():
    """The f32 forward's wrapper takes CUDA tensors of one dtype only and
    counts no launch when it refuses."""
    q = torch.zeros(2, 16, 8)
    before = t_fa.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fa.flash_attention(q, q, q, lse=True)
    with pytest.raises(TypeError, match="expected torch.float32"):
        t_fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="expected torch.float32"):
        t_fa.flash_attention(q, q, q.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_fa.flash_attention(q.double(), q.double(), q.double())
    assert t_fa.launches == before


def test_flash_attention_bwd_plan_fits_one_cta():
    plan = t_fa.bwd_plan((32, 4096, 256), (2, 4096, 256))
    # D = 256: kv tiles of 32 rows in the dq launch (Q and dO of both
    # consumers take 128 KB); each launch within one CTA's shared memory
    assert (plan["dp"], plan["bk"]) == (256, 32)
    assert plan["dq_smem_bytes"] <= t_fa.MAX_SMEM
    assert plan["dkdv_smem_bytes"] <= t_fa.MAX_SMEM
    # the dkdv launch: 64 kv rows a CTA, the consumers split by gradient;
    # a prep launch for Delta before the dq launch
    assert (plan["bkv"], plan["kv_stages"], plan["dkdv_split"]) == (
        64, 2, "gradient")
    assert plan["launches"] == ("prep", "dq", "dkdv")
    # one kv head per 16 query heads: two groups of query heads (a
    # cluster of two CTAs a kv block) fill the 132 SMs
    assert plan["groups"] == 2
    assert plan["dkdv_ctas"] == 64 * 2 * 2 >= 132
    assert plan["dq_ctas"] == 32 * 32 and plan["s_pad"] == 4096
    for d in (64, 128):
        small = t_fa.bwd_plan((4, 1000, d), (4, 1000, d))
        assert small["groups"] == 1 and small["s_pad"] == 1024
        assert max(small["dq_smem_bytes"],
                   small["dkdv_smem_bytes"]) <= t_fa.MAX_SMEM
        # 128 kv rows a dkdv CTA, 64 a consumer with their own dK and dV,
        # on four stages of q and dO tiles; the dq launch's 64-key tiles
        assert (small["bkv"], small["kv_stages"], small["dkdv_split"],
                small["bk"], small["dq_stages"]) == (128, 4, "rows", 64, 4)
        assert small["dkdv_ctas"] == 8 * 4
        # the dq launch computes Delta and lse2 of its rows: two launches
        assert small["launches"] == ("dq", "dkdv")
    # D = 128: k and v of 128 rows (64 KB), four stages of q and dO (32
    # KB) with lse2 and Delta (512 B), the padding and 9 mbarriers
    plan = t_fa.bwd_plan((64, 2048, 128), (64, 2048, 128))
    assert plan["dkdv_smem_bytes"] == 1024 + 64 * 1024 + 4 * (
        32 * 1024 + 512) + 72
    assert plan["groups"] == 1 and plan["dkdv_ctas"] == 16 * 64
    # dq: q, dO and o tiles of both consumers (96 KB), four stages of 64-row
    # k and v tiles (128 KB), the padding and 17 mbarriers
    assert plan["dq_smem_bytes"] == 1024 + 96 * 1024 + 128 * 1024 + 136 \
        <= t_fa.MAX_SMEM


# The D = 128 attention of the uniform stack's full-size configs at a
# prefill of 4 x 4096 tokens: (arch, query heads, kv heads, window).
UNIFORM_D128 = (("yi-6b", 32, 4, 0), ("glm4-9b", 32, 2, 0),
                ("olmoe-1b-7b", 16, 16, 0), ("mixtral-8x22b", 48, 8, 4096))


@pytest.mark.parametrize("arch,heads,kv_heads,window", UNIFORM_D128)
def test_attention_plans_at_the_uniform_stacks_d128_shapes(
        arch, heads, kv_heads, window):
    """The bf16 forward and backward plans at each D = 128 family's
    prefill shape: the configs' heads and window, the persistent forward
    on 128-key tiles with one CTA an SM, the backward's dkdv on 128-row kv
    blocks (a cluster of two CTAs a kv block while the kv blocks of the kv
    heads are under two waves), every launch within one CTA's shared
    memory, and the sources' tiles the plans restate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    cfg = get_config(arch)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        heads, kv_heads, 128)
    # a global layer runs with no window, a local one at the config's
    assert set(cfg.attn_pattern) == ({"local"} if window else {"global"})
    assert window in (0, cfg.window)
    q_shape, kv_shape = (4 * heads, 4096, 128), (4 * kv_heads, 4096, 128)
    plan = t_fa.launch_plan(q_shape, kv_shape, kv_shape, torch.bfloat16)
    assert plan["rep"] == heads // kv_heads
    assert (plan["dp"], plan["bq"], plan["bk"], plan["stages"]) == (
        128, 128, 128, 3)
    assert plan["persistent"] and plan["items"] == 32 * 4 * heads
    assert plan["ctas"] == _build.NUM_SMS <= plan["items"]
    assert plan["smem_bytes"] <= t_fa.MAX_SMEM
    bwd = t_fa.bwd_plan(q_shape, kv_shape, torch.bfloat16)
    assert (bwd["bkv"], bwd["dkdv_split"]) == (128, "rows")
    kv_blocks = 32 * 4 * kv_heads
    assert bwd["groups"] == (2 if heads > kv_heads
                             and kv_blocks < 2 * _build.NUM_SMS else 1)
    assert bwd["dkdv_ctas"] == kv_blocks * bwd["groups"]
    assert max(bwd["dq_smem_bytes"], bwd["dkdv_smem_bytes"]) \
        <= t_fa.MAX_SMEM
    fwd_src = (_build.CSRC / "flash_attention.cu").read_text()
    bwd_src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert f"constexpr int kBK2 = {t_fa.BF16_BK};" in fwd_src
    assert f"constexpr int kBKV2 = {t_fa.BF16_BWD_BKV};" in bwd_src


# ---------------------------------------------------------------------------
# Cross-attention: k and v with S_kv rows against q's S (whisper's decoder
# reading the encoder's frames), non-causal with no window.  The reference
# computes it in jnp (``repro.models.attention._full_attention``); the port
# runs it through the flash kernel, whose plain versions are held here.
# ---------------------------------------------------------------------------

# (BH, BH_kv, S_q, S_kv, D): one query row, fewer and more query rows than
# keys, keys below one kv tile of either kernel (5 < 32), grouped kv heads,
# and whisper's encoder length.
CROSS = ((4, 4, 1, 37, 16), (4, 4, 9, 50, 16), (6, 3, 70, 24, 32),
         (4, 2, 33, 5, 16), (2, 2, 16, 1500, 64))


def _cross_inputs(bh, bh_kv, s_q, s_kv, d, seed=21):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, s_q, d)).astype(np.float32)
    k, v = (rng.normal(size=(bh_kv, s_kv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(bh, s_q, d)).astype(np.float32)
    return q, k, v, do


def _ref_cross(q, k, v, rep):
    """The reference's ``_full_attention`` (non-causal, no window) on the
    folded layout: (BH, S, D) as (1, S, BH, D), kv heads expanded."""
    from types import SimpleNamespace

    from repro.models import attention as jattention

    cfg = SimpleNamespace(head_dim=q.shape[-1], attn_softcap=0.0)
    fold = lambda t: jnp.swapaxes(t, 0, 1)[None]          # noqa: E731
    out = jattention._full_attention(
        cfg, fold(q), fold(jnp.repeat(k, rep, 0)), fold(jnp.repeat(v, rep, 0)),
        window=0, causal=False)
    return jnp.swapaxes(out[0], 0, 1)


@pytest.mark.parametrize("bh,bh_kv,s_q,s_kv,d", CROSS)
def test_cross_attention_plain_matches_reference(bh, bh_kv, s_q, s_kv, d):
    """``attention_plain`` with S_kv != S_q against the reference's jnp
    attention, f32 and bf16, and its lse against logsumexp of the scaled
    scores."""
    q, k, v, _ = _cross_inputs(bh, bh_kv, s_q, s_kv, d)
    rep = bh // bh_kv
    want = _ref_cross(*(jnp.asarray(a) for a in (q, k, v)), rep)
    for dtype in ("float32", "bfloat16"):
        (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
        got = tops.flash_attention(qt, kt, vt, causal=False)
        assert got.shape == (bh, s_q, d) and got.dtype == T_DTYPE[dtype]
        _close(got, _ref_cross(qj, kj, vj, rep) if dtype == "bfloat16"
               else want, dtype)
    out, lse = tref.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=False, lse=True)
    s = torch.einsum("bqd,bkd->bqk", torch.from_numpy(q),
                     torch.from_numpy(k).repeat_interleave(rep, 0))
    assert lse.shape == (bh, s_q)
    assert torch.allclose(lse, torch.logsumexp(s / math.sqrt(d), -1),
                          atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("bh,bh_kv,s_q,s_kv,d", CROSS)
def test_cross_attention_grads_match_autograd_and_reference(bh, bh_kv, s_q,
                                                            s_kv, d):
    """The CPU backward (``ref.attention_bwd_plain``) at S_kv != S_q: dQ
    (BH, S_q, D), dK and dV (BH_kv, S_kv, D), against autograd through the
    plain forward (1e-5) and ``jax.grad`` of the reference's attention
    (1e-4)."""
    q, k, v, do = _cross_inputs(bh, bh_kv, s_q, s_kv, d, seed=22)
    rep = bh // bh_kv
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tops.flash_attention(*leaves, causal=False),
                              leaves, torch.from_numpy(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(
        tops.flash_attention(*leaves, causal=False, mode="plain"), leaves,
        torch.from_numpy(do))
    ref = jax.grad(
        lambda q, k, v: jnp.sum(_ref_cross(q, k, v, rep) * jnp.asarray(do)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, w, r, a in zip(got, want, ref, (q, k, v)):
        assert tuple(g.shape) == a.shape and g.dtype == torch.float32
        assert _rel_frob(g, w) <= 1e-5
        assert _rel_frob(g, r) <= 1e-4


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 8),
                                           (True, 8)])
def test_cross_attention_needs_non_causal_with_no_window(causal, window):
    """S_kv != S_q is a cross-attention: a causal or windowed call with
    k and v of another length raises ``ValueError`` naming the rule, in
    the plain versions and in the kernels' launch plan."""
    q = torch.zeros(4, 16, 16)
    k = torch.zeros(4, 24, 16)
    with pytest.raises(ValueError, match="S_kv may differ from S only"):
        tops.flash_attention(q, k, k, causal=causal, window=window)
    with pytest.raises(ValueError, match="S_kv may differ from S only"):
        tref.attention_bwd_plain(q, k, k, q, torch.zeros(4, 16), q,
                                 causal=causal, window=window)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="S_kv may differ from S only"):
            t_fa.launch_plan(q.shape, k.shape, k.shape, dtype, causal=causal,
                             window=window)
    # the same k and v at q's length, or non-causal with no window, pass
    t_fa.launch_plan(q.shape, q.shape, q.shape, torch.bfloat16,
                     causal=causal, window=window)
    assert t_fa.launch_plan(q.shape, k.shape, k.shape, torch.bfloat16,
                            causal=False)["s_kv"] == 24


# The attention calls of whisper-large-v3 (20 heads of 64, 4 requests, a
# prompt of 416 and 1500 encoder frames; training at 448) and of
# phi-3-vision-4.2b (32 heads of 96, 4 requests of 4096 positions; training
# 2 x 2192): (q shape, kv shape, causal).
WHISPER_PHI3 = (((80, 1500, 64), (80, 1500, 64), False),
                ((80, 416, 64), (80, 416, 64), True),
                ((80, 416, 64), (80, 1500, 64), False),
                ((80, 448, 64), (80, 1500, 64), False),
                ((128, 4096, 96), (128, 4096, 96), True),
                ((64, 2192, 96), (64, 2192, 96), True))


@pytest.mark.parametrize("q_shape,kv_shape,causal", WHISPER_PHI3)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_plans_at_whisper_and_phi3_shapes(q_shape, kv_shape,
                                                     causal, dtype):
    """The forward and backward plans at the two models' shapes fit one
    CTA's shared memory: the forward's q blocks over S_q, the backward's
    dkdv kv blocks over S_kv and its dq launch and workspace over S_q;
    head dimension 96 pads to no column (a multiple of 16) and runs the
    kernels compiled for 128."""
    plan = t_fa.launch_plan(q_shape, kv_shape, kv_shape, dtype,
                            causal=causal)
    assert plan["smem_bytes"] <= t_fa.MAX_SMEM
    assert plan["items"] == -(-q_shape[1] // plan["bq"]) * q_shape[0]
    assert plan["s_kv"] == kv_shape[1] and plan["d_pad"] == q_shape[2]
    assert plan["dp"] == (64 if q_shape[2] == 64 else 128)
    bwd = t_fa.bwd_plan(q_shape, kv_shape, dtype)
    assert bwd["d_pad"] == q_shape[2]
    assert max(bwd["dq_smem_bytes"], bwd["dkdv_smem_bytes"]) <= t_fa.MAX_SMEM
    assert bwd["dq_ctas"] == -(-q_shape[1] // bwd["bq"]) * q_shape[0]
    assert bwd["dkdv_ctas"] == (-(-kv_shape[1] // bwd["bkv"]) * kv_shape[0]
                                * bwd["groups"])
    s_pad = q_shape[1] if dtype == torch.float32 else bwd["s_pad"]
    assert bwd["ws_shape"][-1] == s_pad >= q_shape[1]
