"""The port's whisper-large-v3 encoder-decoder against the JAX package's.

On ``whisper_large_v3``'s smoke config (f32: 2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, 24 encoder frames, LayerNorm, GELU,
learned positions, tied embeddings), the reference's weights
(``repro.models.transformer.init_params(cfg, PRNGKey(0))``) go to the
port with ``convert.lm_params_from_numpy``, and the tokens and frames
(scale 0.02, as ``tests/test_models.py`` draws them) are made with numpy:

* the config and the param tree (``enc_pos``, ``dec_pos`` of 40960 rows,
  ``encoder``, ``enc_final_norm``, ``decoder`` with ``self_attn``,
  ``norm_x`` and ``cross_attn``), bf16 leaves carried across exactly;
* ``prefill``: the last-position logits, the decoder's self cache and the
  cross ``cross_k`` and ``cross_v`` of the encoder's output;
* ``serve_step`` chained after the prefill, and ``serve_batch`` (zero
  frames, as the reference serves them) to the same greedy tokens;
* ``forward``, and ``loss_fn`` with its gradients against
  ``jax.value_and_grad``, with and without ``remat="block"``;
* the trainer refuses whisper before any step (its loader has no
  frames; the reference fails with ``KeyError: 'frames'``),
  ``make_train_step`` trains it on a batch that holds frames, and the
  trainer does when its caller gives frames: its first loss is the
  reference's on the reference loader's first batch with them.

Tolerances as the other parity tests: 1e-4 absolute on logits and cache
leaves (``test_torch_lm_serve.py``), 1e-5 relative on the loss and 1e-4
relative Frobenius on every gradient leaf (``test_torch_train.py``).  On
the CPU the port's attention (the encoder's non-causal self-attention,
the decoder's causal one and the cross-attention, whose k and v have the
encoder's 24 rows against the decoder's S) runs the flash kernel's plain
versions.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCH = "whisper-large-v3"
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
TINY_M = 1e-7
MAX_SEQ = 24


def _cfgs(**over):
    cj = jconfigs.get_smoke_config(ARCH)
    ct = tconfigs.get_smoke_config(ARCH)
    if over:
        cj = dataclasses.replace(cj, **over)
        ct = dataclasses.replace(ct, **over)
    return cj, ct


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = _cfgs()
    params_j = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _inputs(cfg, b, s, seed=0):
    """Tokens (B, S), next-token labels, a mask, and frames (B,
    encoder_seq, d_model) at scale 0.02, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    frames = (0.02 * rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
              ).astype(np.float32)
    return {"tokens": toks, "labels": labels, "mask": mask,
            "frames": frames}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def _frob(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_config_and_param_tree(model):
    cfg_j, cfg_t, params_j, params_t = model
    assert cfg_t == type(cfg_t)(**vars(cfg_j))
    assert tconfigs.get_config(ARCH) == type(cfg_t)(
        **vars(jconfigs.get_config(ARCH)))
    assert tconfigs.get_config(ARCH).param_count() == \
        jconfigs.get_config(ARCH).param_count()
    fresh = ttransformer.init_params(cfg_t, 0, device="cpu")
    ref = dict(_leaves(jtransformer.param_shapes(cfg_j)))
    got = dict(_leaves(fresh))
    assert sorted(ref) == sorted(got)
    assert "/dec_pos" in got and got["/dec_pos"].shape[0] == 40960
    for path, s in ref.items():
        assert tuple(got[path].shape) == tuple(s.shape), path
        assert got[path].dtype == torch.float32, path
    # the whole tree in bf16 (the full config's dtype) carries across
    # exactly
    bf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        params_j)
    back = convert.lm_params_from_numpy(bf16, device="cpu")
    for path, r in _leaves(bf16):
        g = dict(_leaves(back))[path]
        assert g.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r, np.float32), err_msg=path)


def _ref_prefill(cfg, params, batch):
    step = jax.jit(functools.partial(jtransformer.prefill, cfg,
                                     max_seq=MAX_SEQ))
    return step(params, batch)


@pytest.mark.parametrize("s", [1, 9, 16])
def test_prefill_logits_and_caches_match_reference(model, s):
    """The decoder's S (one row, and fewer rows than the encoder's 24
    frames) against the encoder's keys."""
    cfg_j, cfg_t, params_j, params_t = model
    batch = _inputs(cfg_j, 2, s, seed=s)
    inp = {k: batch[k] for k in ("tokens", "frames")}
    lj, cj = _ref_prefill(cfg_j, params_j, _j(inp))
    lt, ct = ttransformer.prefill(cfg_t, params_t, _t(inp), max_seq=MAX_SEQ)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    assert sorted(ct) == ["cross_k", "cross_v", "self"]
    assert tuple(ct["cross_k"].shape) == (cfg_t.num_layers, 2,
                                          cfg_t.encoder_seq,
                                          cfg_t.num_kv_heads,
                                          cfg_t.head_dim)
    _assert_tree_close(cj, ct)


def test_serve_steps_after_prefill_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    s = 10
    inp = {k: v for k, v in _inputs(cfg_j, 3, s, seed=1).items()
           if k in ("tokens", "frames")}
    lj, cj = _ref_prefill(cfg_j, params_j, _j(inp))
    lt, ct = ttransformer.prefill(cfg_t, params_t, _t(inp), max_seq=MAX_SEQ)
    jstep = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    cur = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for step in range(4):
        pos = s + step
        lj, cj = jstep(params_j, cj, jnp.asarray(cur),
                       jnp.asarray(pos, jnp.int32))
        lt, ct_new = ttransformer.serve_step(cfg_t, params_t, ct,
                                             torch.from_numpy(cur), pos)
        assert ct_new["cross_k"] is ct["cross_k"]   # read, not rewritten
        ct = ct_new
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL)
        _assert_tree_close(cj, ct)
        cur = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)


def test_serve_batch_greedy_tokens_match_reference(model):
    """Both drivers serve on zero frames: the same greedy tokens."""
    cfg_j, cfg_t, params_j, params_t = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg_j.vocab_size, n).astype(np.int32)
               for n in (12, 7, 3)]
    rj, _ = jserve.serve_batch(
        cfg_j, params_j, [jserve.Request(rid=i, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)], max_seq=MAX_SEQ)
    rt, _ = tserve.serve_batch(
        cfg_t, params_t, [tserve.Request(rid=i, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)], max_seq=MAX_SEQ)
    assert [r.out for r in rt] == [r.out for r in rj]
    frames = tserve.modality_inputs(cfg_t, 3, "cpu")["frames"]
    assert tuple(frames.shape) == (3, cfg_t.encoder_seq, cfg_t.d_model)
    assert not frames.any()


def test_forward_matches_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    inp = {k: v for k, v in _inputs(cfg_j, 2, 16, seed=2).items()
           if k in ("tokens", "frames")}
    hj = jax.jit(functools.partial(jtransformer.forward, cfg_j))(
        params_j, _j(inp))
    ht = ttransformer.forward(cfg_t, params_t, _t(inp))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_grads_match_reference(remat):
    cfg_j, cfg_t = _cfgs(remat=remat)
    pj = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                      device="cpu")
    batch = _inputs(cfg_j, 2, 16, seed=3)
    lj, gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(cfg_j, p, _j(batch)))(pj)
    lt, gt = tsteps.value_and_grad(tsteps.make_loss_fn(cfg_t), pt,
                                   _t(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    ref = dict(_leaves(gj))
    got = dict(_leaves(gt))
    assert sorted(ref) == sorted(got)
    for path, g in ref.items():
        assert _frob(got[path].numpy(), np.asarray(g)) <= GRAD_RTOL, path
    # the cross-attention's k and v weights reach the loss through the
    # encoder-length keys
    assert float(got["/decoder/cross_attn/wk"].abs().max()) > 0


def test_trainer_refuses_whisper_and_make_train_step_trains_it():
    cfg_j, cfg_t = _cfgs()
    with pytest.raises(ValueError, match="frames"):
        ttrain.train(cfg_t, steps=1, seq=16, global_batch=2, dp=1,
                     ckpt_dir=None, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        ttransformer.loss_fn(cfg_t, ttransformer.init_params(
            cfg_t, 0, device="cpu"), {"tokens": torch.ones((1, 4),
                                                           dtype=torch.long)})
    pj = jtransformer.init_params(cfg_j, jax.random.PRNGKey(1))
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                      device="cpu")
    batch = _inputs(cfg_j, 2, 16, seed=4)
    opt_cfg = jadamw.AdamWConfig()
    jstep = jax.jit(jsteps.make_train_step(cfg_j, opt_cfg))
    lj, pj, oj = jstep(pj, jadamw.adamw_init(pj), _j(batch))
    tstep = tsteps.make_train_step(cfg_t, tadamw.AdamWConfig())
    lt, pt, ot = tstep(pt, tadamw.adamw_init(pt), _t(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    # One step moves each param by about lr: within 1e-5, except where
    # the first moment is below 1e-7 (a gradient within 100 eps of zero,
    # where AdamW's g / (|g| + eps) magnifies a rounding difference;
    # test_torch_train.py): there within the bound of a step, 2 lr.
    mj, mt = dict(_leaves(oj["m"])), dict(_leaves(ot["m"]))
    got = dict(_leaves(pt))
    for path, r in _leaves(pj):
        d = np.abs(got[path].detach().numpy() - np.asarray(r))
        tiny = np.abs(np.asarray(mj[path])) < TINY_M
        assert d[~tiny].max(initial=0.0) <= PARAM_ATOL, path
        assert d[tiny].max(initial=0.0) <= 2 * opt_cfg.lr, path
        assert _frob(mt[path].numpy(), np.asarray(mj[path])) <= GRAD_RTOL


def test_trainer_trains_whisper_on_given_frames(model):
    cfg_j, cfg_t, params_j, _ = model
    frames = _inputs(cfg_j, 2, 16, seed=5)["frames"]
    loader = jpipeline.BalancedLoader(vocab_size=cfg_j.vocab_size, dp=1,
                                      batch_per_shard=2, seq=16, seed=0)
    toks, labels, mask = loader.next_batch()
    batch = {"tokens": toks, "labels": labels, "mask": mask,
             "frames": frames}
    lj = float(jtransformer.loss_fn(cfg_j, params_j, _j(batch)))
    # the trainer updates its params in place: a copy of the fixture's
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params_j),
                                      device="cpu")
    _, _, losses = ttrain.train(
        cfg_t, steps=2, seq=16, global_batch=2, dp=1, ckpt_dir=None,
        device="cpu", log_every=100, init_params=pt,
        extras={"frames": torch.from_numpy(frames)})
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - lj) <= LOSS_RTOL * abs(lj)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                 "20", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s" in out
