"""The port's training path against the JAX package's, on the CPU.

On the smoke configs (RecurrentGemma-9B's, one (R, R, A) period and a
2-layer RG-LRU tail; Mamba-2 1.3B's, 3 SSD layers with chunk 8; both
f32), the reference's weights (``repro.models.transformer.init_params``)
and one numpy batch go to both packages:

* ``loss_fn``: the loss within 1e-5 relative, every gradient leaf within
  1e-4 relative Frobenius of ``jax.value_and_grad`` (the port runs its
  autograd Functions with the plain forward and backward of
  ``kernels/ref.py``; the reference its jnp training forward), also at a
  Mamba-2 S that is not a multiple of the chunk (``apply_ssd``'s padding)
  and under ``remat="block"``;
* ``chunked_loss`` against ``cross_entropy`` and against the reference's
  ``chunked_loss``, value and gradients, within 1e-5;
* one ``make_train_step`` step, also with ``accum_steps = 2``, and
  resume across packages: the reference's ``train`` runs 2 steps with
  ``--ckpt-dir`` and the port resumes it to step 4; then the port runs 2
  steps from the reference's initial weights and the reference resumes
  it to step 4, both held to the reference's uninterrupted run (which
  needs the loader's state to cross the packages too).  Each loss within
  1e-5 relative, ``m`` and ``v`` within 1e-4 relative Frobenius (the
  gradients' tolerance), ``step`` equal, and the params within 1e-5
  absolute (they are O(0.1-1); a step moves them by about lr), except
  where the reference's first moment is below 1e-7, a gradient within
  100 eps of zero: there AdamW's g / (|g| + eps) turns a 1e-4 relative
  gradient difference into a visible part of a step (measured: 0.2 of
  one at a gradient of 3e-8), so those elements are held to the bound of
  the steps taken, 2 lr a step;
* prefill + one decode step equals the training forward on the extended
  sequence (the reference's ``test_decode_matches_forward``), 1e-4.

The uniform attention stack (``UNIFORM``: the smoke configs of Yi, Gemma,
GLM-4, gemma3, OLMoE and Mixtral) gets the loss and every gradient leaf,
one train step (Mixtral's with ``accum_steps`` = 2, through the
microbatch loop) and prefill + decode against the forward, at the same
tolerances.  The MoE configs run the reference with its DyDD schedule
rounded exactly (``_torch_exact_schedule``), as the port rounds; for
decode against the forward they turn balancing off and raise the
capacity, as the reference's own test does, since a token's route
depends on the other tokens of its sequence.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_exact_schedule import exact_reference_schedule  # noqa: E402,F401
from _torch_exact_schedule import tied_migrations  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert as tconvert  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
TINY_M = 1e-7
ARCHS = ("recurrentgemma_9b", "mamba2_1_3b")


def _cfgs(arch, **over):
    cj = jconfigs.get_smoke_config(arch)
    ct = tconfigs.get_smoke_config(arch)
    if over:
        cj = dataclasses.replace(cj, **over)
        ct = dataclasses.replace(ct, **over)
    return cj, ct


def _params(cfg_j, seed=0):
    pj = jtransformer.init_params(cfg_j, jax.random.PRNGKey(seed))
    return pj, tconvert.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                             device="cpu")


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.zeros_like(toks)
    labels[:, :-1] = toks[:, 1:]
    mask = (rng.random((b, s)) < 0.9).astype(np.float32)
    mask[:, -1] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pairs(tree_t, tree_j):
    """(path, port leaf as numpy, reference leaf as numpy) of every leaf."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
        node = tree_t
        for p in path:
            node = node[p.key]
        out.append(("/".join(p.key for p in path),
                    node.detach().float().numpy(), np.asarray(leaf)))
    return out


def _frob(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch,s,remat", [
    ("recurrentgemma_9b", 32, "none"),
    ("recurrentgemma_9b", 32, "block"),
    ("mamba2_1_3b", 32, "none"),
    ("mamba2_1_3b", 28, "none"),       # S not a multiple of the chunk (8)
    ("mamba2_1_3b", 28, "block"),
])
def test_loss_and_grads_match_reference(arch, s, remat):
    cfg_j, cfg_t = _cfgs(arch, remat=remat)
    pj, pt = _params(cfg_j)
    batch = _batch(cfg_j, 2, s)
    lj, gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(cfg_j, p, _j(batch)))(pj)
    lt, gt = tsteps.value_and_grad(tsteps.make_loss_fn(cfg_t), pt,
                                    _t(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    pairs = _pairs(gt, gj)
    assert len(pairs) == len(tadamw.leaves(gt))
    for path, a, b in pairs:
        assert a.shape == b.shape, path
        assert _frob(a, b) <= GRAD_RTOL, (path, _frob(a, b))


def test_chunked_loss_matches_cross_entropy_and_reference():
    rng = np.random.default_rng(3)
    B, S, D, V, chunk = 2, 24, 16, 40, 8
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    emb = rng.normal(size=(V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    for cap in (0.0, 30.0):
        ht, et = (torch.from_numpy(x).requires_grad_() for x in (h, emb))
        got = tnn.chunked_loss(ht, et, torch.from_numpy(labels), chunk, cap,
                               torch.from_numpy(mask))
        dh, de = torch.autograd.grad(got, (ht, et))
        full = tnn.cross_entropy(tnn.softcap(ht @ et.T, cap),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
        fh, fe = torch.autograd.grad(full, (ht, et))
        lj, (gh, ge) = jax.value_and_grad(
            lambda a, b: jnn.chunked_loss(a, b, jnp.asarray(labels), chunk,
                                          cap, jnp.asarray(mask)),
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
        for x, y in ((float(got.detach()), float(lj)),
                     (float(full.detach()), float(lj))):
            assert abs(x - y) <= LOSS_RTOL * abs(y)
        for x, y in ((dh, gh), (de, ge), (fh, gh), (fe, ge)):
            assert _frob(x.numpy(), np.asarray(y)) <= LOSS_RTOL


@pytest.mark.parametrize("arch,accum", [("recurrentgemma_9b", 1),
                                        ("mamba2_1_3b", 1),
                                        ("mamba2_1_3b", 2)])
def test_train_step_matches_reference(arch, accum):
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(cfg_j)
    batch = _batch(cfg_j, 4, 32)
    oj = jadamw.AdamWConfig(lr=1e-3, accum_steps=accum)
    ot = tadamw.AdamWConfig(lr=1e-3, accum_steps=accum)
    step_j = jsteps.make_train_step(cfg_j, oj, donate=False)
    step_t = tsteps.make_train_step(cfg_t, ot)
    lj, pj, sj = step_j(pj, jadamw.adamw_init(pj), _j(batch))
    lt, pt, st = step_t(pt, tadamw.adamw_init(pt), _t(batch))
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    assert int(st["step"]) == int(sj["step"]) == 1
    _check_state(pt, st, pj, sj, 2 * 1e-3)


def _check_state(params_t, opt_t, params_j, opt_j, steps_bound):
    tiny = {path: np.abs(b) < TINY_M
            for path, _, b in _pairs(opt_t["m"], opt_j["m"])}
    for path, a, b in _pairs(params_t, params_j):
        d = np.abs(a - b)
        assert d[~tiny[path]].max(initial=0.0) <= PARAM_ATOL, path
        assert d[tiny[path]].max(initial=0.0) <= steps_bound, path
    for tree_t, tree_j in ((opt_t["m"], opt_j["m"]),
                           (opt_t["v"], opt_j["v"])):
        for path, a, b in _pairs(tree_t, tree_j):
            assert _frob(a, b) <= GRAD_RTOL, (path, _frob(a, b))


TRAIN = dict(steps=4, seq=32, global_batch=4, dp=2, log_every=100)
STEPS_BOUND = 2 * 3e-4 * TRAIN["steps"]   # 2 lr a step at the peak lr


def _reference_run(cfg_j, **kw):
    return jtrain.train(cfg_j, ckpt_dir=None, **dict(TRAIN, **kw))


def _check_run(params_t, opt_t, losses, ref):
    pj, oj, lj = ref
    np.testing.assert_allclose(losses, lj[-len(losses):], rtol=LOSS_RTOL)
    _check_state(params_t, opt_t, pj, oj, STEPS_BOUND)
    assert int(opt_t["step"]) == int(oj["step"]) == TRAIN["steps"]


def test_port_resumes_the_reference_run(tmp_path):
    cfg_j, cfg_t = _cfgs("mamba2_1_3b")
    ref = _reference_run(cfg_j)
    jtrain.train(cfg_j, ckpt_dir=str(tmp_path), **dict(TRAIN, steps=2))
    params, opt, losses = ttrain.train(cfg_t, ckpt_dir=str(tmp_path),
                                       device="cpu", **TRAIN)
    assert len(losses) == 2     # resumed at 2, ran 2..3
    _check_run(params, opt, losses, ref)


def test_reference_resumes_the_port_run(tmp_path):
    cfg_j, cfg_t = _cfgs("recurrentgemma_9b")
    ref = _reference_run(cfg_j)
    pj = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    init = tconvert.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                         device="cpu")
    _, _, first = ttrain.train(cfg_t, ckpt_dir=str(tmp_path), device="cpu",
                               init_params=init, **dict(TRAIN, steps=2))
    params, opt, losses = jtrain.train(cfg_j, ckpt_dir=str(tmp_path),
                                       **TRAIN)
    assert len(losses) == 2
    np.testing.assert_allclose(first + losses, ref[2], rtol=LOSS_RTOL)
    # the reference's own trees against its uninterrupted run
    _check_state(tconvert.lm_params_from_numpy(
                     jax.tree.map(np.asarray, params), device="cpu"),
                 tconvert.adamw_state_from_numpy(
                     jax.tree.map(np.asarray, opt), device="cpu"),
                 ref[0], ref[1], STEPS_BOUND)
    assert int(opt["step"]) == TRAIN["steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    cfg_j, cfg_t = _cfgs(arch)
    _, pt = _params(cfg_j)
    B, S = 2, 16
    toks = torch.from_numpy(_batch(cfg_j, B, S)["tokens"]).long()
    with torch.no_grad():
        logits_last, cache = ttransformer.prefill(cfg_t, pt, {"tokens": toks},
                                                  max_seq=S + 8)
        nxt = torch.argmax(logits_last, -1)[:, None]
        logits2, _ = ttransformer.serve_step(cfg_t, pt, cache, nxt, S)
        h = ttransformer.forward(cfg_t, pt,
                                 {"tokens": torch.cat([toks, nxt], 1)})
        ref = ttransformer.logits_fn(cfg_t, pt, h[:, -1:, :])[:, 0]
    err = float((logits2[:, 0] - ref).abs().max() / ref.abs().max())
    assert err < 1e-4, err


# ---------------------------------------------------------------------------
# The uniform attention stack, dense and MoE.
# ---------------------------------------------------------------------------

UNIFORM = ("yi_6b", "gemma_7b", "glm4_9b", "gemma3_1b", "olmoe_1b_7b",
           "mixtral_8x22b")


@pytest.mark.parametrize("arch,remat", [(a, "none") for a in UNIFORM]
                         + [("gemma3_1b", "block"),
                            ("olmoe_1b_7b", "block")])
def test_uniform_loss_and_grads_match_reference(arch, remat,
                                                exact_reference_schedule):
    test_loss_and_grads_match_reference(arch, 32, remat)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
def test_moe_loss_and_grads_match_unpatched_reference_off_ties(
        arch, monkeypatch):
    """The MoE models' loss and grads against the reference with its own
    ``schedule_jnp``, unpatched, on the first batch (seeds 0, 1, ...)
    whose every DyDD schedule in the port's run has no migration of
    exactly a half-integer: off those ties float ``rint`` and the port's
    exact rounding agree, so this parity rests on the unmodified
    reference alone."""
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _params(cfg_j)
    seen = []
    target = tmoe.dydd_target_counts

    def spy(counts, ops, capacity):
        seen.append(counts.reshape(-1, counts.shape[-1]).numpy().copy())
        return target(counts, ops, capacity)

    monkeypatch.setattr(tmoe, "dydd_target_counts", spy)
    loss_fn = tsteps.make_loss_fn(cfg_t)
    for seed in range(20):
        seen.clear()
        batch = _batch(cfg_j, 2, 32, seed)
        lt, gt = tsteps.value_and_grad(loss_fn, pt, _t(batch))
        assert len(seen) == cfg_t.num_layers
        if not any(tied_migrations(c).any() for c in seen):
            break
    else:
        pytest.fail("every batch has a tied migration")
    lj, gj = jax.value_and_grad(
        lambda p: jtransformer.loss_fn(cfg_j, p, _j(batch)))(pj)
    assert abs(float(lt) - float(lj)) <= LOSS_RTOL * abs(float(lj))
    pairs = _pairs(gt, gj)
    assert len(pairs) == len(tadamw.leaves(gt))
    for path, a, b in pairs:
        assert _frob(a, b) <= GRAD_RTOL, (path, _frob(a, b))


@pytest.mark.parametrize("arch", UNIFORM)
def test_uniform_train_step_matches_reference(arch,
                                              exact_reference_schedule):
    test_train_step_matches_reference(
        arch, 2 if arch == "mixtral_8x22b" else 1)


@pytest.mark.parametrize("arch", UNIFORM)
def test_uniform_decode_matches_forward(arch):
    cfg_j, cfg_t = _cfgs(arch)
    over = ({"moe_dydd_balance": False, "capacity_factor": 4.0}
            if cfg_t.num_experts else {})
    cfg_t = dataclasses.replace(cfg_t, **over)
    _, pt = _params(cfg_j)
    B, S = 2, 16
    toks = torch.from_numpy(_batch(cfg_j, B, S)["tokens"]).long()
    with torch.no_grad():
        logits_last, cache = ttransformer.prefill(cfg_t, pt, {"tokens": toks},
                                                  max_seq=S + 8)
        nxt = torch.argmax(logits_last, -1)[:, None]
        logits2, _ = ttransformer.serve_step(cfg_t, pt, cache, nxt, S)
        h = ttransformer.forward(cfg_t, pt,
                                 {"tokens": torch.cat([toks, nxt], 1)})
        ref = ttransformer.logits_fn(cfg_t, pt, h[:, -1:, :])[:, 0]
    err = float((logits2[:, 0] - ref).abs().max() / ref.abs().max())
    assert err < 1e-4, err


def test_train_driver_takes_the_configs_accumulation(monkeypatch):
    """``launch.train.train`` accumulates ``cfg.train_accum`` microbatches
    a step (Mixtral's 8 at full size; 2 here): a step takes the gradients
    of each half of the batch, and its loss is the mean of theirs."""
    _, cfg_t = _cfgs("mixtral_8x22b", train_accum=2)
    init = ttransformer.init_params(cfg_t, 0, device="cpu")
    rows = []

    def counted(loss_fn, params, batch):
        rows.append(int(batch["tokens"].shape[0]))
        return value_and_grad(loss_fn, params, batch)

    value_and_grad = tsteps.value_and_grad
    monkeypatch.setattr(tsteps, "value_and_grad", counted)
    _, _, losses = ttrain.train(
        cfg_t, steps=1, seq=16, global_batch=4, dp=2, log_every=100,
        ckpt_dir=None, device="cpu",
        init_params=tadamw.tree_map(torch.clone, init))
    assert rows == [2, 2]
    loader = tpipeline.BalancedLoader(vocab_size=cfg_t.vocab_size, dp=2,
                                      batch_per_shard=2, seq=16, seed=0)
    batch = ttrain.batch_on("cpu", *loader.next_batch())
    loss_fn = tsteps.make_loss_fn(cfg_t)
    with torch.no_grad():
        halves = [float(loss_fn(init, {k: v[2 * i:2 * i + 2]
                                       for k, v in batch.items()}))
                  for i in range(2)]
    assert abs(losses[0] - np.mean(halves)) <= LOSS_RTOL * abs(losses[0])
