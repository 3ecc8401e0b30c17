"""The port's Mamba-2 serving path against the JAX package's.

Both packages compute with the same weights: the reference's
``transformer.init_params(cfg, PRNGKey(0))`` on ``mamba2_1_3b``'s smoke
config (f32, 3 SSD layers, d_model 64, 8 heads of 16, state 16, chunk
8), carried across with ``convert.lm_params_from_numpy``.  Prompts are
made with numpy.

Tolerance: max-abs 1e-4 at f32 on logits (magnitude ~30) and on every
cache leaf; the port's scan sums its cumulative decay in f64 and in
other orders than the reference's, which leaves differences of ~2e-5.
Greedy tokens must be equal.  On the CPU the port's prefill runs the
``ssd_scan`` kernel's plain version.
"""
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402

ARCH = "mamba2-1.3b"
ATOL = 1e-4
MAX_SEQ = 48
ROOT = pathlib.Path(__file__).resolve().parents[1]


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
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL, err_msg=path)


def _prompts(batch, length, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (batch, length))


def _ref_prefill(cfg, params, tokens):
    step = jax.jit(functools.partial(jtransformer.prefill, cfg,
                                     max_seq=MAX_SEQ))
    return step(params, {"tokens": jnp.asarray(tokens, jnp.int32)})


def test_configs_and_param_tree(model):
    cfg_j, cfg_t, params_j, params_t = model
    assert cfg_t == type(cfg_t)(**vars(cfg_j))
    full = tconfigs.get_config(ARCH)
    assert full == type(full)(**vars(jconfigs.get_config(ARCH)))
    assert full.param_count() == jconfigs.get_config(ARCH).param_count()
    assert round(full.param_count() / 1e9, 3) == 1.343
    # The port's own initializer builds the reference's tree.
    fresh = ttransformer.init_params(cfg_t, 0, device="cpu")
    ref = dict(_leaves(jtransformer.param_shapes(cfg_j)))
    got = dict(_leaves(fresh))
    assert sorted(ref) == sorted(got)
    assert {p.rsplit("/", 1)[1] for p in got if "/ssd/" in p} == {
        "A_log", "D", "dt_bias", "conv_w", "conv_b", "norm", "in_proj",
        "out_proj"}
    for path, s in ref.items():
        assert tuple(got[path].shape) == tuple(s.shape), path
        assert got[path].dtype == torch.float32, path
    again = ttransformer.init_params(cfg_t, 0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(fresh), _leaves(again)))
    _assert_tree_close(params_j, params_t)
    _assert_tree_close(jtransformer.init_decode_cache(cfg_j, 2, MAX_SEQ),
                       ttransformer.init_decode_cache(cfg_t, 2, MAX_SEQ,
                                                      device="cpu"))


@pytest.mark.parametrize("length", [40, 5])
def test_prefill_matches_reference(model, length):
    """40 is five chunks of 8; 5 is below one chunk (chunk = S)."""
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _prompts(2, length)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    before = tops.launch_counts()
    logits_t, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    assert tops.launch_counts() == before   # the CPU runs no kernel
    assert logits_t.shape == (2, cfg_t.vocab_size)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=0, atol=ATOL)
    _assert_tree_close(cache_j, cache_t)
    assert cache_t["state"].shape == (3, 2, 8, 16, 16)
    assert cache_t["state"].dtype == torch.float32


def test_prefill_hands_the_scan_contiguous_ungrouped_tensors(model,
                                                            monkeypatch):
    """What the CUDA kernel takes: contiguous f32, x and dt with the
    heads folded into the batch, B and C one row per (batch, group)."""
    _, cfg_t, _, params_t = model
    calls = []
    scan = tops.ssd_scan

    def spy(*args, **kwargs):
        calls.append(args)
        return scan(*args, **kwargs)

    monkeypatch.setattr(tops, "ssd_scan", spy)
    ttransformer.prefill(cfg_t, params_t,
                         {"tokens": torch.as_tensor(_prompts(2, 16))})
    assert len(calls) == cfg_t.num_layers
    for x, dt, A, B, C in calls:
        assert [tuple(t.shape) for t in (x, dt, A, B, C)] == [
            (16, 16, 16), (16, 16), (16,), (2, 16, 16), (2, 16, 16)]
        assert all(t.is_contiguous() and t.dtype == torch.float32
                   for t in (x, dt, A, B, C))


def test_prefill_off_the_chunk_raises_as_the_reference_does(model):
    """S = 12 >= chunk 8 and not a multiple of it: the reference's
    prefill fails in a reshape, the port's with a ValueError."""
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _prompts(2, 12)
    with pytest.raises(TypeError, match="reshape"):
        _ref_prefill(cfg_j, params_j, tokens)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ttransformer.prefill(cfg_t, params_t,
                             {"tokens": torch.as_tensor(tokens)})


def test_chained_serve_steps_match_reference(model):
    cfg_j, cfg_t, params_j, params_t = model
    tokens = _prompts(2, 16, seed=1)
    logits_j, cache_j = _ref_prefill(cfg_j, params_j, tokens)
    _, cache_t = tsteps.make_prefill_step(cfg_t, max_seq=MAX_SEQ)(
        params_t, {"tokens": torch.as_tensor(tokens)})
    serve_j = jax.jit(functools.partial(jtransformer.serve_step, cfg_j))
    serve_t = tsteps.make_serve_step(cfg_t)
    cur = np.array(jnp.argmax(logits_j, -1))[:, None]
    for step in range(4):
        logits_j, cache_j = serve_j(params_j, cache_j,
                                    jnp.asarray(cur, jnp.int32),
                                    jnp.asarray(16 + step, jnp.int32))
        before = tops.launch_counts()
        logits_t, cache_t = serve_t(params_t, cache_t, torch.as_tensor(cur),
                                    16 + step)
        assert tops.launch_counts() == before
        assert logits_t.shape == (2, 1, cfg_t.vocab_size)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   rtol=0, atol=ATOL)
        _assert_tree_close(cache_j, cache_t)
        cur = np.array(jnp.argmax(logits_j, -1))


def _requests(cls, lengths, max_new, seed=2):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 512, n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(lengths, max_new))]


@pytest.mark.parametrize("lengths,max_new", [
    ((40, 23, 31), (6, 6, 6)), ((7, 3), (5, 3))])
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
    """Each wave's longest prompt is a multiple of the chunk or below it."""
    cfg_j, cfg_t, params_j, params_t = model
    lengths, max_new = (16, 9, 24, 5, 7), (4, 4, 4, 4, 4)
    ref, _ = jserve.serve_queue(cfg_j, params_j,
                                _requests(jserve.Request, lengths, max_new),
                                slots=2, max_seq=MAX_SEQ)
    got, agg = tserve.serve_queue(
        cfg_t, params_t, _requests(tserve.Request, lengths, max_new),
        slots=2, max_seq=MAX_SEQ)
    assert agg["waves"] == 3
    assert [r.rid for r in got] == [r.rid for r in ref]
    assert [r.out for r in got] == [r.out for r in ref]


def test_cli_runs_on_the_cpu(capsys):
    """Prompts of 4-7 tokens, below the smoke config's chunk of 8."""
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                 "8", "--max-new", "3", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s" in out


def test_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttransformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttransformer.init_decode_cache(cfg, 1, 16)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--batch", "1", "--prompt-len", "8", "--max-new", "1"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
