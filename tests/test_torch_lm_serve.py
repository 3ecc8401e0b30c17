"""The port's RecurrentGemma serving path against the JAX package's.

Both packages compute with the same weights: the reference's
``transformer.init_params(cfg, PRNGKey(0))`` on ``recurrentgemma_9b``'s
smoke config (f32, 5 layers = one (rglru, rglru, local) period plus a
2-layer RG-LRU tail, window 16), carried across with
``convert.lm_params_from_numpy``.  Prompts are made with numpy.

The uniform attention stack (``UNIFORM``: Yi, Gemma, GLM-4, gemma3's
local and global mixture, OLMoE and Mixtral, each on its smoke config)
runs the same checks: the param tree, prefill logits and caches, chained
decode steps, greedy tokens through ``serve_batch`` and the CLI.  The
MoE configs run the reference with its DyDD schedule rounded exactly
(``_torch_exact_schedule``: at a migration of exactly a half-integer the
reference's float rounding lands on either side), as the port rounds.
A global layer takes no window: Yi's and OLMoE's smoke configs with
``window=8`` still match the reference at S = 32.

Tolerance: max-abs 1e-4 at f32 on logits (magnitude ~70) and on every
cache leaf; the two packages sum in other orders (the reference scans
with an associative scan and blocked softmax, the port one step at a
time), which leaves differences of ~2e-5.  Cache positions and greedy
tokens must be equal.  On the CPU the port's prefill runs the kernels'
plain versions.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_exact_schedule import exact_reference_schedule  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCH = "recurrentgemma-9b"
ATOL = 1e-4
PROMPT = 40          # > window 16: the ring cache keeps the last 16
MAX_SEQ = 48


@pytest.fixture(scope="module")
def model():
    cfg_j = jconfigs.get_smoke_config(ARCH)
    cfg_t = tconfigs.get_smoke_config(ARCH)
    params_j = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


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
        r, g = np.asarray(r), got_leaves[path].numpy()
        assert r.shape == g.shape, path
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=path)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=ATOL,
                                       err_msg=path)


def _prompts(batch, length, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (batch, length))


def _ref_prefill(cfg, params, tokens):
    step = jax.jit(functools.partial(jtransformer.prefill, cfg,
                                     max_seq=MAX_SEQ))
    return step(params, {"tokens": jnp.asarray(tokens, jnp.int32)})


def test_configs_and_param_tree(model):
    cfg_j, cfg_t, params_j, params_t = model
    assert cfg_t == type(cfg_t)(**vars(cfg_j))
    assert tconfigs.get_config(ARCH).param_count() == \
        jconfigs.get_config(ARCH).param_count()
    # whisper's encoder-decoder and the phi3-vision stub are ported too
    # (tests/test_torch_whisper.py, tests/test_torch_vlm.py)
    for arch in ("whisper-large-v3", "phi3-vision-4.2b"):
        for get in ("get_config", "get_smoke_config"):
            want = getattr(jconfigs, get)(arch)
            assert getattr(tconfigs, get)(arch) == type(
                tconfigs.get_config(ARCH))(**vars(want))
    # The port's own initializer builds the reference's tree.
    fresh = ttransformer.init_params(cfg_t, 0, device="cpu")
    shapes = jtransformer.param_shapes(cfg_j)
    ref = dict(_leaves(shapes))
    got = dict(_leaves(fresh))
    assert sorted(ref) == sorted(got)
    for path, s in ref.items():
        assert tuple(got[path].shape) == tuple(s.shape), path
        assert got[path].dtype == torch.float32, path
    again = ttransformer.init_params(cfg_t, 0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(fresh), _leaves(again)))
    # bf16 leaves (the full configs' dtype) carry across exactly
    bf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        params_j["periods"]["attn"]["norm1"])
    got = convert.lm_params_from_numpy(
        {"w": np.asarray(params_j["embed"][:3].astype(jnp.bfloat16)),
         "n": bf16}, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].float().numpy(),
        np.asarray(params_j["embed"][:3].astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", False)])
def test_nn_primitives_match_reference(act, gated):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    w, b = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    wt, wj, bt, bj = (torch.from_numpy(w), jnp.asarray(w),
                      torch.from_numpy(b), jnp.asarray(b))
    pos = np.broadcast_to(np.arange(7), (2, 7))
    pairs = [
        (tnn.rms_norm(xt, wt, 1e-6), jnn.rms_norm(xj, wj, 1e-6)),
        (tnn.layer_norm(xt, wt, bt, 1e-6), jnn.layer_norm(xj, wj, bj, 1e-6)),
        (tnn.rope(xt, torch.from_numpy(pos.copy()), 10000.0),
         jnn.rope(xj, jnp.asarray(pos), 10000.0)),
        (tnn.softcap(xt, 5.0), jnn.softcap(xj, 5.0)),
    ]
    mlp = {"w_up": rng.normal(size=(16, 24)) / 4,
           "w_down": rng.normal(size=(24, 16)) / 5}
    if gated:
        mlp["w_gate"] = rng.normal(size=(16, 24)) / 4
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    pairs.append((
        tnn.apply_mlp({k: torch.from_numpy(v) for k, v in mlp.items()}, xt,
                      act, gated),
        jnn.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()}, xj, act,
                      gated)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_block_pieces_match_reference(model):
    """The RG-LRU block's prefill body, the additive mask and the empty
    decode cache, which the serving path builds otherwise."""
    cfg_j, cfg_t, params_j, params_t = model
    x = np.random.default_rng(4).normal(size=(2, 21, 64)).astype(np.float32)
    got = trglru.apply_rglru(cfg_t, ttransformer._index(
        params_t["periods"]["r1"], 0)["rglru"], torch.from_numpy(x))
    want = jrglru.apply_rglru(cfg_j, jax.tree.map(
        lambda a: a[0], params_j["periods"]["r1"])["rglru"], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for window, causal in ((16, True), (0, True), (5, False)):
        np.testing.assert_array_equal(
            tattention._mask(9, 12, window, causal, q_offset=3).numpy(),
            np.asarray(jattention._mask(9, 12, window, causal, q_offset=3),
                       np.float32))
    _assert_tree_close(jtransformer.init_decode_cache(cfg_j, 2, MAX_SEQ),
                       ttransformer.init_decode_cache(cfg_t, 2, MAX_SEQ,
                                                      device="cpu"))


def test_prefill_matches_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _prompts(2, PROMPT)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    before = tops.launch_counts()
    logits_t, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    assert tops.launch_counts() == before   # the CPU runs no kernel
    assert logits_t.shape == (2, cfg_t.vocab_size)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=0, atol=ATOL)
    _assert_tree_close(cache_j, cache_t)
    # the ring keeps the last `window` positions of the 40-token prompt
    np.testing.assert_array_equal(cache_t["attn"]["pos"][0].numpy(),
                                  np.arange(PROMPT - 16, PROMPT))


def test_chained_serve_steps_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _prompts(2, PROMPT, seed=1)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    _, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    serve_j = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    serve_t = tsteps.make_serve_step(cfg_t)
    cur = np.array(jnp.argmax(logits_j, -1))[:, None]
    for step in range(4):
        logits_j, cache_j = serve_j(params_j, cache_j,
                                    jnp.asarray(cur, jnp.int32),
                                    jnp.asarray(PROMPT + step, jnp.int32))
        logits_t, cache_t = serve_t(params_t, cache_t, torch.as_tensor(cur),
                                    PROMPT + step)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   rtol=0, atol=ATOL)
        _assert_tree_close(cache_j, cache_t)
        cur = np.array(jnp.argmax(logits_j, -1))


def _requests(cls, lengths, max_new, seed=2):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 512, n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("lengths,max_new", [
    ((40, 23, 31), (6, 6, 6)), ((12, 20), (5, 3))])
def test_serve_batch_greedy_tokens_match_reference(model, lengths, max_new):
    cfg_j, cfg_t, params_j, params_t = model
    ref, _ = jserve.serve_batch(cfg_j, params_j,
                                _requests(jserve.Request, lengths, max_new),
                                max_seq=MAX_SEQ)
    got, stats = tserve.serve_batch(
        cfg_t, params_t, _requests(tserve.Request, lengths, max_new),
        max_seq=MAX_SEQ)
    assert [r.out for r in got] == [r.out for r in ref]
    assert [len(r.out) for r in got] == list(max_new)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("length", [1, 2])
def test_prompt_shorter_than_the_conv_cache_raises(model, length):
    """Decode reads conv width - 1 = 3 rows of the conv cache.  For a
    longest prompt of 1 or 2 tokens the reference clamps the index and
    decodes wrong logits; the port's prefill refuses it before any
    decode step, alone and inside ``serve_batch``."""
    _, cfg_t, _, params_t = model
    before = tops.launch_counts()
    with pytest.raises(ValueError, match="conv width minus one"):
        ttransformer.prefill(cfg_t, params_t,
                             {"tokens": torch.as_tensor(_prompts(2, length))},
                             max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="conv width minus one"):
        tserve.serve_batch(cfg_t, params_t,
                           _requests(tserve.Request, (length, 1), (2, 2)),
                           max_seq=MAX_SEQ)
    assert tops.launch_counts() == before


def test_three_token_prompt_decodes_as_the_reference(model):
    """The shortest longest-prompt the conv cache allows still serves
    the reference's greedy tokens."""
    cfg_j, cfg_t, params_j, params_t = model
    lengths, max_new = (3, 2), (4, 4)
    ref, _ = jserve.serve_batch(cfg_j, params_j,
                                _requests(jserve.Request, lengths, max_new),
                                max_seq=MAX_SEQ)
    got, _ = tserve.serve_batch(
        cfg_t, params_t, _requests(tserve.Request, lengths, max_new),
        max_seq=MAX_SEQ)
    assert [r.out for r in got] == [r.out for r in ref]
    assert [len(r.out) for r in got] == list(max_new)


def test_serve_queue_greedy_tokens_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    lengths, max_new = (33, 18, 40, 9, 25), (4, 4, 4, 4, 4)
    ref, _ = jserve.serve_queue(cfg_j, params_j,
                                _requests(jserve.Request, lengths, max_new),
                                slots=2, max_seq=MAX_SEQ)
    got, agg = tserve.serve_queue(
        cfg_t, params_t, _requests(tserve.Request, lengths, max_new),
        slots=2, max_seq=MAX_SEQ)
    assert agg["waves"] == 3
    assert [r.rid for r in got] == [r.rid for r in ref]
    assert [r.out for r in got] == [r.out for r in ref]


def test_sampling_draws_from_the_seeded_generator(model):
    _, cfg_t, _, params_t = model

    def run(seed):
        reqs = _requests(tserve.Request, (20, 14), (5, 5))
        return [r.out for r in tserve.serve_batch(
            cfg_t, params_t, reqs, max_seq=MAX_SEQ, greedy=False,
            seed=seed)[0]]

    first = run(7)
    assert first == run(7)
    assert all(0 <= t < cfg_t.vocab_size for out in first for t in out)


def test_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                 "20", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s" in out


# ---------------------------------------------------------------------------
# The uniform attention stack, dense and MoE.
# ---------------------------------------------------------------------------

UNIFORM = ("yi-6b", "gemma-7b", "glm4-9b", "gemma3-1b", "olmoe-1b-7b",
           "mixtral-8x22b")


def _pair(arch, **over):
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg_t = tconfigs.get_smoke_config(arch)
    if over:
        cfg_j = cfg_j.scaled(**over)
        cfg_t = cfg_t.scaled(**over)
    params_j = jtransformer.init_params(cfg_j, jax.random.PRNGKey(0))
    params_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.fixture(scope="module", params=UNIFORM)
def uniform(request):
    return _pair(request.param)


def test_uniform_configs_and_param_tree(uniform):
    cfg_j, cfg_t, params_j, params_t = uniform
    assert cfg_t == type(cfg_t)(**vars(cfg_j))
    assert tconfigs.get_config(cfg_t.name).param_count() == \
        jconfigs.get_config(cfg_j.name).param_count()
    fresh = ttransformer.init_params(cfg_t, 0, device="cpu")
    ref = dict(_leaves(jtransformer.param_shapes(cfg_j)))
    got = dict(_leaves(fresh))
    assert sorted(ref) == sorted(got)
    assert ("/blocks/moe/router" in got) == (cfg_t.num_experts > 0)
    for path, s in ref.items():
        assert tuple(got[path].shape) == tuple(s.shape), path
        assert got[path].dtype == torch.float32, path
    # the reference's weights carry across and back leaf for leaf
    back = convert.lm_params_to_numpy(params_t)
    for path, a in _leaves(jax.tree.map(np.asarray, params_j)):
        np.testing.assert_array_equal(dict(_leaves(back))[path], a)


def test_uniform_prefill_matches_reference(uniform, exact_reference_schedule):
    cfg_j, cfg_t, params_j, params_t = uniform
    tokens = _prompts(2, PROMPT, seed=3)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    before = tops.launch_counts()
    logits_t, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    assert tops.launch_counts() == before
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=0, atol=ATOL)
    _assert_tree_close(cache_j, cache_t)
    _assert_tree_close(jtransformer.init_decode_cache(cfg_j, 2, MAX_SEQ),
                       ttransformer.init_decode_cache(cfg_t, 2, MAX_SEQ,
                                                      device="cpu"))


def test_uniform_chained_serve_steps_match_reference(
        uniform, exact_reference_schedule):
    cfg_j, cfg_t, params_j, params_t = uniform
    tokens = _prompts(2, PROMPT, seed=4)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    _, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    serve_j = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    serve_t = tsteps.make_serve_step(cfg_t)
    cur = np.array(jnp.argmax(logits_j, -1))[:, None]
    for step in range(4):
        logits_j, cache_j = serve_j(params_j, cache_j,
                                    jnp.asarray(cur, jnp.int32),
                                    jnp.asarray(PROMPT + step, jnp.int32))
        logits_t, cache_t = serve_t(params_t, cache_t, torch.as_tensor(cur),
                                    PROMPT + step)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   rtol=0, atol=ATOL)
        _assert_tree_close(cache_j, cache_t)
        cur = np.array(jnp.argmax(logits_j, -1))


def test_uniform_serve_batch_greedy_tokens_match_reference(
        uniform, exact_reference_schedule):
    cfg_j, cfg_t, params_j, params_t = uniform
    lengths, max_new = (40, 23, 31), (6, 6, 6)
    ref, _ = jserve.serve_batch(cfg_j, params_j,
                                _requests(jserve.Request, lengths, max_new),
                                max_seq=MAX_SEQ)
    got, _ = tserve.serve_batch(
        cfg_t, params_t, _requests(tserve.Request, lengths, max_new),
        max_seq=MAX_SEQ)
    assert [r.out for r in got] == [r.out for r in ref]


@pytest.mark.parametrize("arch", UNIFORM)
def test_uniform_cli_runs_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--batch", "3", "--prompt-len",
                 "20", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s" in out


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b"])
def test_global_layers_take_no_window(arch, exact_reference_schedule):
    """A global layer attends to every earlier position whatever
    ``cfg.window`` says: the smoke config with window 8 at S = 32 still
    matches the reference in the forward, the prefill and a decode step,
    and differs from a local layer's result."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch, window=8)
    tokens = _prompts(2, 32, seed=5)
    h_j = jtransformer.forward(cfg_j, params_j,
                               {"tokens": jnp.asarray(tokens, jnp.int32)})
    h_t = ttransformer.forward(cfg_t, params_t,
                               {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                               rtol=0, atol=ATOL)
    local = cfg_t.scaled(attn_pattern=("local",))
    h_l = ttransformer.forward(local, params_t,
                               {"tokens": torch.as_tensor(tokens)})
    assert float((h_l - h_t).abs().max()) > 100 * ATOL
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    logits_t, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=0, atol=ATOL)
    cur = np.array(jnp.argmax(logits_j, -1))[:, None]
    lj, _ = jtransformer.serve_step(cfg_j, params_j, cache_j,
                                    jnp.asarray(cur, jnp.int32),
                                    jnp.asarray(32, jnp.int32))
    lt, _ = tsteps.make_serve_step(cfg_t)(params_t, cache_t,
                                          torch.as_tensor(cur), 32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
