"""The port's phi-3-vision-4.2b (the phi3-mini backbone with its CLIP
frontend stubbed) against the JAX package's.

On ``phi3_vision_4_2b``'s smoke config (f32: 2 layers, d_model 64, 4
heads of 16, 8 patches, RMSNorm, SwiGLU, rope), the reference's weights
(``repro.models.transformer.init_params(cfg, PRNGKey(0))``) go to the
port with ``convert.lm_params_from_numpy``, and the tokens and the patch
embeddings (scale 0.02, as ``tests/test_models.py`` draws them) are made
with numpy.  The batch's ``"patches"`` (B, P, d_model) are prepended to
the token embeddings, so the trunk runs P + S positions:

* the config and the param tree, bf16 leaves carried across exactly;
* ``prefill`` with patches: the last-position logits and the caches of
  P + S positions;
* ``serve_step`` chained after it at positions P + S, P + S + 1, ...,
  and ``serve_batch`` (zero patches, as the reference serves them, the
  decode positions run P further) to the same greedy tokens;
* ``forward``, and ``loss_fn`` (over the text tail alone) with its
  gradients against ``jax.value_and_grad``, with patches and without
  (the training CLI's batches are text);
* the trainer trains it on the loader's text batches, as the
  reference's does, and on them with patches that its caller gives: its
  first loss is the reference's on the reference loader's first batch
  with them.

Tolerances as the other parity tests: 1e-4 absolute on logits and cache
leaves, 1e-5 relative on the loss and 1e-4 relative Frobenius on every
gradient leaf.  On the CPU the port's attention runs the flash kernel's
plain versions.
"""
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCH = "phi3-vision-4.2b"
ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MAX_SEQ = 32        # text positions; the caches hold P more


@pytest.fixture(scope="module")
def model():
    cfg_j = jconfigs.get_smoke_config(ARCH)
    cfg_t = tconfigs.get_smoke_config(ARCH)
    params_j = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _inputs(cfg, b, s, seed=0, patches=True):
    """Tokens (B, S), next-token labels and a mask over the text, and
    patches (B, P, d_model) at scale 0.02, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if patches:
        out["patches"] = (0.02 * rng.normal(
            size=(b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return out


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


def _assert_tree_close(ref, got):
    ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
    assert sorted(ref_leaves) == sorted(got_leaves)
    for path, r in ref_leaves.items():
        r, g = np.asarray(r), got_leaves[path].detach().numpy()
        assert r.shape == g.shape, path
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=path)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL, err_msg=path)


def _frob(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_config_and_param_tree(model):
    cfg_j, cfg_t, params_j, params_t = model
    assert cfg_t == type(cfg_t)(**vars(cfg_j))
    assert tconfigs.get_config(ARCH) == type(cfg_t)(
        **vars(jconfigs.get_config(ARCH)))
    assert tconfigs.get_config("phi-3-vision-4.2b") == \
        tconfigs.get_config(ARCH)
    assert tconfigs.get_config(ARCH).param_count() == \
        jconfigs.get_config(ARCH).param_count()
    fresh = ttransformer.init_params(cfg_t, 0, device="cpu")
    ref = dict(_leaves(jtransformer.param_shapes(cfg_j)))
    got = dict(_leaves(fresh))
    assert sorted(ref) == sorted(got)
    for path, s in ref.items():
        assert tuple(got[path].shape) == tuple(s.shape), path
    bf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        params_j)
    back = dict(_leaves(convert.lm_params_from_numpy(bf16, device="cpu")))
    for path, r in _leaves(bf16):
        assert back[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(back[path].float().numpy(),
                                      np.asarray(r, np.float32), err_msg=path)


def _ref_prefill(cfg, params, batch, max_seq):
    step = jax.jit(functools.partial(jtransformer.prefill, cfg,
                                     max_seq=max_seq))
    return step(params, batch)


@pytest.mark.parametrize("s,patches", [(12, True), (3, True), (12, False)])
def test_prefill_logits_and_caches_match_reference(model, s, patches):
    cfg_j, cfg_t, params_j, params_t = model
    batch = _inputs(cfg_j, 2, s, seed=s, patches=patches)
    inp = {k: batch[k] for k in ("tokens", "patches") if k in batch}
    max_seq = MAX_SEQ + cfg_j.num_patches
    lj, cj = _ref_prefill(cfg_j, params_j, _j(inp), max_seq)
    lt, ct = ttransformer.prefill(cfg_t, params_t, _t(inp), max_seq=max_seq)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    _assert_tree_close(cj, ct)
    pos = ct["full"]["pos"][0].numpy()
    assert (pos >= 0).sum() == s + (cfg_j.num_patches if patches else 0)


def test_serve_steps_after_prefill_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    s, p = 10, cfg_j.num_patches
    inp = {k: v for k, v in _inputs(cfg_j, 3, s, seed=1).items()
           if k in ("tokens", "patches")}
    max_seq = MAX_SEQ + p
    lj, cj = _ref_prefill(cfg_j, params_j, _j(inp), max_seq)
    lt, ct = ttransformer.prefill(cfg_t, params_t, _t(inp), max_seq=max_seq)
    jstep = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    cur = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for step in range(4):
        pos = p + s + step
        lj, cj = jstep(params_j, cj, jnp.asarray(cur),
                       jnp.asarray(pos, jnp.int32))
        lt, ct = ttransformer.serve_step(cfg_t, params_t, ct,
                                         torch.from_numpy(cur), pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL)
        _assert_tree_close(cj, ct)
        cur = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)


def test_serve_batch_greedy_tokens_match_reference(model):
    """Both drivers serve on zero patches, decode positions P past the
    prompt's: the same greedy tokens."""
    cfg_j, cfg_t, params_j, params_t = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg_j.vocab_size, n).astype(np.int32)
               for n in (14, 6, 9)]
    rj, _ = jserve.serve_batch(
        cfg_j, params_j, [jserve.Request(rid=i, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)], max_seq=20)
    rt, _ = tserve.serve_batch(
        cfg_t, params_t, [tserve.Request(rid=i, prompt=p, max_new=6)
                          for i, p in enumerate(prompts)], max_seq=20)
    assert [r.out for r in rt] == [r.out for r in rj]


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                 "20", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s" in out


def test_forward_matches_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    inp = {k: v for k, v in _inputs(cfg_j, 2, 16, seed=2).items()
           if k in ("tokens", "patches")}
    hj = jax.jit(functools.partial(jtransformer.forward, cfg_j))(
        params_j, _j(inp))
    ht = ttransformer.forward(cfg_t, params_t, _t(inp))
    assert tuple(ht.shape) == (2, 16 + cfg_t.num_patches, cfg_t.d_model)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("patches", [True, False])
def test_loss_and_grads_match_reference(model, patches):
    cfg_j, cfg_t, params_j, params_t = model
    batch = _inputs(cfg_j, 2, 16, seed=3, patches=patches)
    lj, gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(cfg_j, p, _j(batch)))(params_j)
    lt, gt = tsteps.value_and_grad(tsteps.make_loss_fn(cfg_t), params_t,
                                   _t(batch))
    for p in jax.tree.leaves(params_t):
        p.requires_grad_(False)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    ref, got = dict(_leaves(gj)), dict(_leaves(gt))
    assert sorted(ref) == sorted(got)
    for path, g in ref.items():
        assert _frob(got[path].numpy(), np.asarray(g)) <= GRAD_RTOL, path


def test_trainer_trains_on_text():
    """The training driver's loader batches are text (no patches), as the
    reference's: a few steps run and the losses are finite."""
    cfg = tconfigs.get_smoke_config(ARCH)
    _, _, losses = ttrain.train(cfg, steps=2, seq=16, global_batch=2, dp=1,
                                ckpt_dir=None, device="cpu", log_every=100)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_trainer_trains_on_given_patches(model):
    """The trainer with patches given (``extras``; its CLI gives none):
    its first loss is the reference's ``loss_fn`` on the reference
    loader's first batch with those patches, over the text tail."""
    cfg_j, cfg_t, params_j, _ = model
    patches = _inputs(cfg_j, 2, 16, seed=5)["patches"]
    loader = jpipeline.BalancedLoader(vocab_size=cfg_j.vocab_size, dp=1,
                                      batch_per_shard=2, seq=16, seed=0)
    toks, labels, mask = loader.next_batch()
    batch = {"tokens": toks, "labels": labels, "mask": mask,
             "patches": patches}
    lj = float(jtransformer.loss_fn(cfg_j, params_j, _j(batch)))
    # the trainer updates its params in place: a copy of the fixture's
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params_j),
                                      device="cpu")
    _, _, losses = ttrain.train(
        cfg_t, steps=2, seq=16, global_batch=2, dp=1, ckpt_dir=None,
        device="cpu", log_every=100, init_params=pt,
        extras={"patches": torch.from_numpy(patches)})
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - lj) <= LOSS_RTOL * abs(lj)
