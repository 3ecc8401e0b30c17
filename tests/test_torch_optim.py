"""The port's optimizer, LR schedule and gradient compression against the
JAX package's (``repro.optim``), on the same numpy trees.

Tolerance: 1e-6 relative (the largest |difference| over the largest
|reference| of each leaf) in f32: both run the same f32 arithmetic, in
other orders and with other fusions.  ``compressed_psum`` is a
multi-process all-reduce over a process mesh, held bitwise to the
reference's ``shard_map`` in ``tests/test_torch_mesh_fleet.py``; here,
without a mesh it names the missing argument.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch import convert as t_convert  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _tree(rng, scale=1.0):
    """A nested numpy tree like a model's: a table, a stacked block, a
    vector."""
    return {"embed": (scale * rng.normal(size=(16, 8))).astype(np.float32),
            "blocks": {"w": (scale * rng.normal(size=(3, 8, 4))
                             ).astype(np.float32),
                       "norm": (scale * rng.normal(size=(3, 8))
                                ).astype(np.float32)},
            "final": (scale * rng.normal(size=(8,))).astype(np.float32)}


def _torch(tree):
    return t_convert.lm_params_from_numpy(tree, device="cpu")


def _check_tree(got, want, rtol=RTOL):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        _close(node, leaf, rtol)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(kind):
    t_fn = tschedule.make_schedule(kind, 3e-4, warmup_steps=5,
                                   total_steps=40, final_frac=0.1)
    j_fn = jschedule.make_schedule(kind, 3e-4, warmup_steps=5,
                                   total_steps=40, final_frac=0.1)
    for step in range(0, 45):
        _close(t_fn(step), float(j_fn(step)))


@pytest.mark.parametrize("clip_norm", [1e3, 0.5])
def test_adamw_steps_match_reference(clip_norm):
    """Three AdamW steps: the first step's bias correction, decoupled
    decay, and clipping (0.5 clips every step's grads, 1e3 none)."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1,
                               clip_norm=clip_norm)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, weight_decay=0.1,
                               clip_norm=clip_norm)
    p_j = jax.tree.map(jnp.asarray, params)
    o_j = jadamw.adamw_init(p_j)
    p_t = _torch(params)
    o_t = tadamw.adamw_init(p_t)
    for _ in range(3):
        grads = _tree(rng, scale=0.7)
        p_j, o_j, n_j = jadamw.adamw_step(cfg_j, jax.tree.map(jnp.asarray,
                                                               grads),
                                          o_j, p_j)
        p_t, o_t, n_t = tadamw.adamw_step(cfg_t, _torch(grads), o_t, p_t)
        _close(float(n_t), float(n_j))
    _check_tree(p_t, p_j)
    _check_tree(o_t["m"], o_j["m"])
    _check_tree(o_t["v"], o_j["v"])
    assert int(o_t["step"]) == int(o_j["step"]) == 3


def test_adamw_first_step_is_sign_plus_decay():
    """The reference's first-step maths by hand: mhat = g, vhat = g^2, so
    the step is lr (g / (|g| + eps) + wd p)."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    g = rng.normal(size=(5, 3)).astype(np.float32)
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.1, clip_norm=1e9)
    params = {"w": torch.from_numpy(p.copy())}
    new, opt, _ = tadamw.adamw_step(cfg, {"w": torch.from_numpy(g)},
                                    tadamw.adamw_init(params), params)
    want = p - 0.1 * (g / (np.abs(g) + 1e-8) + 0.1 * p)
    _close(new["w"], want, 1e-5)


def test_adamw_keeps_bf16_params_and_f32_moments():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    opt = tadamw.adamw_init(params)
    assert opt["m"]["w"].dtype == torch.float32
    grads = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}
    params, opt, _ = tadamw.adamw_step(tadamw.AdamWConfig(), grads, opt,
                                       params)
    assert params["w"].dtype == torch.bfloat16
    assert opt["v"]["w"].dtype == torch.float32


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    grads = _tree(rng, scale=3.0)
    g_j, n_j = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                          1.0)
    g_t, n_t = tadamw.clip_by_global_norm(_torch(grads), 1.0)
    _close(float(n_t), float(n_j))
    _check_tree(g_t, g_j)


def test_quantize_dequantize_and_feedback_match_reference():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(33, 7)).astype(np.float32)
    e = (0.01 * rng.normal(size=(33, 7))).astype(np.float32)
    q_t, s_t = tcompress.quantize(torch.from_numpy(g))
    q_j, s_j = jcompress.quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    _close(float(s_t), float(s_j))
    _close(tcompress.dequantize(q_t, s_t), jcompress.dequantize(q_j, s_j))
    q_t, s_t, e_t = tcompress.compress_with_feedback(torch.from_numpy(g),
                                                     torch.from_numpy(e))
    q_j, s_j, e_j = jcompress.compress_with_feedback(jnp.asarray(g),
                                                     jnp.asarray(e))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    _close(e_t, e_j)
    bufs = tcompress.init_error_buffers(_torch(_tree(rng)))
    assert bufs["blocks"]["w"].shape == (3, 8, 4)
    assert float(bufs["blocks"]["w"].abs().sum()) == 0.0


def test_compressed_psum_names_item_13():
    """``compressed_psum`` reduces over an axis of a process mesh (held
    to the reference's on 8 ranks in ``tests/test_torch_mesh_fleet.py``);
    without one it names the missing argument."""
    with pytest.raises(ValueError, match="needs mesh=.*'data' axis"):
        tcompress.compressed_psum(torch.zeros(3), torch.zeros(3), "data")


def test_adamw_state_round_trips_through_numpy():
    rng = np.random.default_rng(4)
    params = _tree(rng)
    opt_j = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    opt_j = {"m": jax.tree.map(lambda x: x + 1.5, opt_j["m"]),
             "v": opt_j["v"], "step": jnp.asarray(7, jnp.int32)}
    opt_t = t_convert.adamw_state_from_numpy(
        jax.tree.map(np.asarray, opt_j), device="cpu")
    assert int(opt_t["step"]) == 7
    back = t_convert.adamw_state_to_numpy(opt_t)
    _check_tree(back["m"], opt_j["m"], 0.0)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 7
