"""Attention soft-capping (``attn_softcap > 0``) in the port against the
JAX package, on the CPU.

The reference caps the scaled scores as cap tanh(s / cap) before the mask
and the softmax in every attention path; the port does so in the flash
kernels (their capped instantiations, on the card) and in their plain
versions (``kernels/ref.py``), which the CPU runs:

* ``attention_plain`` with a cap against the reference's
  ``attention._full_attention`` with ``attn_softcap`` set, f32 and bf16,
  causal, windowed, grouped kv and S_kv != S, at the tolerances of the
  uncapped cases of ``tests/test_torch_lm_kernels.py`` (2e-5, 2e-2);
* ``attention_bwd_plain`` with a cap against autograd through the capped
  ``attention_plain`` in f64 (1e-10 relative Frobenius) and, through the
  autograd Function, against ``jax.grad`` of the reference at f32
  (1e-4);
* the smoke configs of gemma-7b, recurrentgemma-9b (its local layers
  windowed) and whisper-large-v3 (its cross-attention at S_kv != S) with
  the cap set through ``.scaled(attn_softcap=...)`` and the reference's
  weights (``convert``): the loss and every gradient leaf through
  ``loss_parts`` (1e-5, 1e-4), the prefill's logits and caches, and
  three greedy decode steps' logits, caches and tokens (1e-4), as
  ``tests/test_torch_train.py`` and ``tests/test_torch_lm_serve.py``
  hold the same configs uncapped;
* every entry point that refused a capped config takes one.

Every case uses a cap that bites: its inputs reach several caps, and the
capped and uncapped results differ by at least 10 times the tolerance.
"""
import dataclasses
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
CAP = 2.0     # the kernel-level cases' cap
AMP = 2.0     # their q and k: scaled scores of ~ AMP^2 = 2 caps, many more
ATOL = 1e-4   # logits and caches (test_torch_lm_serve.py)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

# (BH, BH_kv, S, S_kv, D, causal, window): causal, windowed with grouped
# kv, grouped kv, and a cross-attention (S_kv != S, non-causal).
CASES = ((4, 4, 64, 64, 16, True, 0), (4, 2, 64, 64, 16, True, 24),
         (8, 2, 48, 48, 32, True, 0), (4, 4, 20, 50, 16, False, 0))


def _inputs(bh, bh_kv, s, s_kv, d, seed):
    rng = np.random.default_rng(seed)
    q = (AMP * rng.normal(size=(bh, s, d))).astype(np.float32)
    k = (AMP * rng.normal(size=(bh_kv, s_kv, d))).astype(np.float32)
    v = rng.normal(size=(bh_kv, s_kv, d)).astype(np.float32)
    do = rng.normal(size=(bh, s, d)).astype(np.float32)
    return q, k, v, do


def _ref_attention(q, k, v, rep, causal, window, cap):
    """The reference's ``_full_attention`` with ``attn_softcap = cap`` on
    the folded layout: (BH, S, D) as (1, S, BH, D), kv heads expanded."""
    cfg = SimpleNamespace(head_dim=q.shape[-1], attn_softcap=cap)
    fold = lambda t: jnp.swapaxes(t, 0, 1)[None]          # noqa: E731
    out = jattention._full_attention(
        cfg, fold(q), fold(jnp.repeat(k, rep, 0)), fold(jnp.repeat(v, rep, 0)),
        window=window, causal=causal)
    return jnp.swapaxes(out[0], 0, 1)


def _rel_frob(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,bh_kv,s,s_kv,d,causal,window", CASES)
def test_attention_plain_softcap_matches_reference(bh, bh_kv, s, s_kv, d,
                                                   causal, window, dtype):
    q, k, v, _ = _inputs(bh, bh_kv, s, s_kv, d, seed=bh + s_kv)
    rep = bh // bh_kv
    tq, tk, tv = (torch.from_numpy(a).to(T_DTYPE[dtype]) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(J_DTYPE[dtype]) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    got = tops.flash_attention(tq, tk, tv, softcap=CAP, **kw)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (bh, s, d)
    want = np.asarray(_ref_attention(jq, jk, jv, rep, causal, window, CAP),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    uncapped = tops.flash_attention(tq, tk, tv, **kw)
    assert float((got.float() - uncapped.float()).abs().max()) >= \
        10 * TOL[dtype]
    # the log-sum-exp the backward reads is that of the capped scores
    _, lse = tref.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  lse=True, softcap=CAP, **kw)
    scores = np.einsum("bqd,bkd->bqk", q, np.repeat(k, rep, 0)) / math.sqrt(d)
    scores = CAP * np.tanh(scores / CAP)
    qpos, kpos = np.arange(s)[:, None], np.arange(s_kv)[None, :]
    ok = np.ones((s, s_kv), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    scores = np.where(ok[None], scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    want_lse = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[
        ..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("bh,bh_kv,s,s_kv,d,causal,window", CASES)
def test_attention_bwd_plain_softcap_matches_autograd_in_f64(
        bh, bh_kv, s, s_kv, d, causal, window):
    """The FA2 plain backward with the cap (P = exp(cap t - lse), every dS
    times 1 - t^2, the f64 dQ's compensated form with g in both terms)
    against autograd through the capped plain forward, both in f64."""
    arrays = _inputs(bh, bh_kv, s, s_kv, d, seed=7 * bh + s_kv)
    q, k, v, do = (torch.from_numpy(a).double() for a in arrays)
    kw = dict(causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = tref.attention_plain(*leaves, lse=True, softcap=CAP, **kw)
    assert out.dtype == torch.float64 and lse.dtype == torch.float64
    want = torch.autograd.grad(out, leaves, do)
    got = tref.attention_bwd_plain(q, k, v, out.detach(), lse.detach(), do,
                                   softcap=CAP, **kw)
    o0, lse0 = tref.attention_plain(q, k, v, lse=True, **kw)
    uncapped = tref.attention_bwd_plain(q, k, v, o0, lse0, do, **kw)
    for g, w, u in zip(got, want, uncapped):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert _rel_frob(g, w) <= 1e-10
        assert _rel_frob(u, g) >= 10 * GRAD_RTOL


@pytest.mark.parametrize("bh,bh_kv,s,s_kv,d,causal,window", CASES)
def test_flash_attention_softcap_grads_match_reference(
        bh, bh_kv, s, s_kv, d, causal, window):
    """The autograd Function (the plain forward and backward on the CPU,
    no launch) with the cap against ``jax.grad`` of the reference's
    capped attention, f32."""
    q, k, v, do = _inputs(bh, bh_kv, s, s_kv, d, seed=3 * bh + s_kv)
    rep = bh // bh_kv
    kw = dict(causal=causal, window=window)
    before = tops.launch_counts()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(
        tops.flash_attention(*leaves, softcap=CAP, **kw), leaves,
        torch.from_numpy(do))
    assert tops.launch_counts() == before
    ref = jax.grad(
        lambda q, k, v: jnp.sum(_ref_attention(q, k, v, rep, causal, window,
                                               CAP) * jnp.asarray(do)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    uncapped = torch.autograd.grad(tops.flash_attention(*leaves, **kw),
                                   leaves, torch.from_numpy(do))
    for g, r, u, a in zip(got, ref, uncapped, (q, k, v)):
        assert tuple(g.shape) == a.shape and g.dtype == torch.float32
        assert _rel_frob(g, r) <= GRAD_RTOL
        assert _rel_frob(u, r) >= 10 * GRAD_RTOL


def test_softcap_must_be_finite_and_non_negative():
    from repro_torch.kernels import flash_attention as t_fa
    assert t_fa.check_softcap("x", 0) == 0.0
    assert t_fa.check_softcap("x", 50) == 50.0
    for bad in (-1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="softcap"):
            t_fa.check_softcap("x", bad)


# ---------------------------------------------------------------------------
# Whole models with the cap.
# ---------------------------------------------------------------------------

# The cap each smoke config takes: the scaled scores of its random
# weights have a median |s| of 0.57-0.69 and reach 4.4-5.1, so Gemma 2's
# 50.0 would not bite; 0.5 puts most scores past a cap and the largest
# at 9-10 caps, and moves the logits by far more than ATOL.
MODEL_CAPS = {"gemma-7b": 0.5, "recurrentgemma-9b": 0.5,
              "whisper-large-v3": 0.5}
MAX_SEQ = 48
PROMPT = 40     # > RecurrentGemma's smoke window of 16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_tree_close(ref, got, atol=ATOL):
    ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
    assert sorted(ref_leaves) == sorted(got_leaves)
    for path, r in ref_leaves.items():
        r, g = np.asarray(r), got_leaves[path].detach().numpy()
        assert r.shape == g.shape, path
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=path)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=path)


@pytest.fixture(scope="module", params=sorted(MODEL_CAPS))
def capped(request):
    """(arch, reference config, port config, reference params, port
    params, the port's uncapped config) with the arch's cap."""
    arch = request.param
    cap = MODEL_CAPS[arch]
    cfg_j = jconfigs.get_smoke_config(arch).scaled(attn_softcap=cap)
    cfg_t = tconfigs.get_smoke_config(arch).scaled(attn_softcap=cap)
    params_j = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return (arch, cfg_j, cfg_t, params_j, params_t,
            cfg_t.scaled(attn_softcap=0.0))


def _batch(cfg, b, s, seed):
    """Tokens, next-token labels, a mask and (whisper) frames at scale
    0.02, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if cfg.is_encoder_decoder:
        out["frames"] = (0.02 * rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompt_batch(cfg, b, s, seed):
    batch = _batch(cfg, b, s, seed)
    return {k: v for k, v in batch.items() if k in ("tokens", "frames")}


def test_model_loss_and_grads_match_reference(capped):
    arch, cfg_j, cfg_t, params_j, params_t, uncapped = capped
    batch = _batch(cfg_j, 2, 24, seed=1)
    lj, gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(cfg_j, p, _j(batch)))(params_j)
    before = tops.launch_counts()
    lt, gt = tsteps.value_and_grad(tsteps.make_loss_fn(cfg_t), params_t,
                                   _t(batch))
    assert tops.launch_counts() == before
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    ref = dict(_leaves(jax.tree.map(np.asarray, gj)))
    got = dict(_leaves(gt))
    assert sorted(ref) == sorted(got)
    for path, r in ref.items():
        g = got[path].detach().numpy()
        assert g.shape == r.shape, path
        assert _rel_frob(g, r) <= GRAD_RTOL, (path, _rel_frob(g, r))
    l0 = float(tsteps.make_loss_fn(uncapped)(params_t, _t(batch)).detach())
    assert abs(l0 - float(lj)) >= 10 * LOSS_RTOL * abs(float(lj))


def test_model_prefill_matches_reference(capped):
    arch, cfg_j, cfg_t, params_j, params_t, uncapped = capped
    inp = _prompt_batch(cfg_j, 2, PROMPT, seed=2)
    lj, cj = jax.jit(functools.partial(jtransformer.prefill, cfg_j,
                                       max_seq=MAX_SEQ))(params_j, _j(inp))
    lt, ct = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(params_t,
                                                              _t(inp))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    _assert_tree_close(cj, ct)
    l0, _ = tsteps.make_prefill_step(uncapped, max_seq=MAX_SEQ)(params_t,
                                                               _t(inp))
    assert float((l0 - lt).abs().max()) >= 10 * ATOL


def test_model_decode_matches_reference(capped):
    """Three greedy decode steps after the prefill (the cap in the
    decode's own attention over the cache, and whisper's cross-attention
    over the cached frames): each step's logits and caches, and its greedy
    token."""
    arch, cfg_j, cfg_t, params_j, params_t, uncapped = capped
    inp = _prompt_batch(cfg_j, 2, PROMPT, seed=3)
    lj, cj = jax.jit(functools.partial(jtransformer.prefill, cfg_j,
                                       max_seq=MAX_SEQ))(params_j, _j(inp))
    _, ct = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(params_t,
                                                             _t(inp))
    _, c0 = tsteps.make_prefill_step(uncapped, max_seq=MAX_SEQ)(params_t,
                                                               _t(inp))
    serve_j = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    serve_t = tsteps.make_serve_step(cfg_t)
    serve_0 = tsteps.make_serve_step(uncapped)
    cur = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    moved = 0.0
    for step in range(3):
        lj, cj = serve_j(params_j, cj, jnp.asarray(cur),
                         jnp.asarray(PROMPT + step, jnp.int32))
        lt, ct = serve_t(params_t, ct, torch.from_numpy(cur), PROMPT + step)
        l0, c0 = serve_0(params_t, c0, torch.from_numpy(cur), PROMPT + step)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL)
        _assert_tree_close(cj, ct)
        moved = max(moved, float((l0 - lt).abs().max()))
        cur = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        np.testing.assert_array_equal(lt.argmax(-1).numpy(), cur)
    assert moved >= 10 * ATOL


ENTRIES = ("init_params", "forward", "loss_parts", "init_decode_cache",
           "prefill", "serve_step")


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_take_a_capped_config(entry):
    """The six entries that refused ``attn_softcap > 0``
    (``NotImplementedError``) run a capped config to finite results."""
    cfg = tconfigs.get_smoke_config("gemma-7b").scaled(attn_softcap=30.0)
    assert cfg.attn_softcap > 0
    params = ttransformer.init_params(cfg, 0, device="cpu")
    if entry == "init_params":
        assert all(torch.isfinite(t).all() for _, t in _leaves(params))
        return
    batch = _t(_batch(cfg, 2, 12, seed=4))
    if entry == "forward":
        out = ttransformer.forward(cfg, params, batch)
    elif entry == "loss_parts":
        out = torch.stack(ttransformer.loss_parts(cfg, params, batch))
    elif entry == "init_decode_cache":
        cache = ttransformer.init_decode_cache(cfg, 2, 16, device="cpu")
        out = torch.cat([t.float().flatten() for _, t in _leaves(cache)])
    elif entry == "prefill":
        out, _ = ttransformer.prefill(cfg, params, batch, max_seq=16)
    else:
        _, cache = ttransformer.prefill(cfg, params, batch, max_seq=16)
        out, _ = ttransformer.serve_step(cfg, params, cache,
                                         batch["tokens"][:, :1], 12)
    assert bool(torch.isfinite(out.float()).all())


def test_no_entry_refuses_the_cap():
    assert not hasattr(ttransformer, "_require_ported")
    assert dataclasses.replace(
        tconfigs.get_config("gemma-7b"), attn_softcap=50.0).attn_softcap == 50
