"""Train, prefill and serve step factories.

The counterparts of ``repro.runtime.steps.make_loss_fn``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``:
eager calls.  The reference's jit and buffer donation have no
counterpart on one device (the AdamW update is in place); its mesh
shardings (data-parallel training) wait for ROADMAP Queue 1 item 7c.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import LM_DTYPES
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def make_loss_fn(cfg: ModelConfig, *, mode: str = "auto"):
    """``loss(params, batch) -> f32 scalar``; ``mode`` goes to the kernel
    ops."""
    def loss(params, batch):
        return transformer.loss_fn(cfg, params, batch, mode=mode)
    return loss


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the grads a tree like
    params, in the params' dtypes (bf16 params give bf16 grads, as in the
    reference); every param leaf is set to require grad."""
    leaves = adamw.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), adamw.tree_map(lambda _: next(grads), params)


# The kernel each layer kind of ``ModelConfig.attn_pattern`` runs.
_KERNEL_OF = {"global": "flash_attention", "local": "flash_attention",
              "rglru": "rglru_scan", "ssd": "ssd_scan"}


def check_trainable(cfg: ModelConfig, dtype: torch.dtype, device) -> None:
    """Refuse, before a step runs, params that the kernels cannot train:
    on the card every layer's forward and backward is a kernel, and each
    takes f32 or bf16 (``flash_attention`` and its backward for attention
    layers, ``rglru_scan`` for recurrent ones, ``ssd_scan`` for SSD ones);
    the CPU runs the plain versions in any dtype."""
    if torch.device(device).type != "cuda" or dtype in LM_DTYPES:
        return
    kernels = " and ".join(sorted({_KERNEL_OF.get(t, t)
                                   for t in cfg.attn_pattern}))
    names = " or ".join(str(d).removeprefix("torch.") for d in LM_DTYPES)
    raise TypeError(
        f"{cfg.name}: training on the card needs {names} params (got "
        f"{dtype}): the {kernels} kernels take no other dtype")


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    lr_schedule=None, mesh=None, *, mode: str = "auto"):
    """Returns ``train_step(params, opt_state, batch) -> (loss, params,
    opt_state)``; the update is in place.  The batch holds what the
    model reads: whisper's ``"frames"`` beside its tokens, phi-3-vision's
    optional ``"patches"``.  With ``opt_cfg.accum_steps``
    = k > 1 the batch splits into k microbatches along its leading axis
    and their grads are summed in f32 and divided by k, as the
    reference's microbatch scan does.  Each step first refuses what
    :func:`check_trainable` refuses: on the card, params in a dtype that
    no kernel takes (f32 and bf16 train there, attention layers
    included).  ``mode`` goes to the kernel ops."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): sharded training is not ported "
            "(ROADMAP Queue 1 item 7c)")
    loss_fn = make_loss_fn(cfg, mode=mode)
    accum = opt_cfg.accum_steps

    def step(params, opt_state, batch):
        leaf = adamw.leaves(params)[0]
        check_trainable(cfg, leaf.dtype, leaf.device)
        lr = (lr_schedule(int(opt_state["step"]))
              if lr_schedule is not None else opt_cfg.lr)
        if accum > 1:
            grads, loss = None, 0.0
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, mb)
                grads = (adamw.tree_map(lambda x: x.float(), g)
                         if grads is None else
                         adamw.tree_map(torch.add, grads, g))
                loss = loss + l
            grads = adamw.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, _ = adamw.adamw_step(opt_cfg, grads, opt_state,
                                                params, lr=lr)
        return loss, params, opt_state

    return step


def make_prefill_step(cfg: ModelConfig, max_seq: int | None = None, *,
                      mode: str = "auto"):
    """``step(params, batch) -> (logits_last (B, V), cache)``; ``mode``
    goes to the prefill's kernel ops."""
    def step(params, batch):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch, max_seq=max_seq,
                                       mode=mode)
    return step


def make_serve_step(cfg: ModelConfig):
    """``step(params, cache, tokens, pos) -> (logits (B, 1, V), cache)``."""
    def step(params, cache, tokens, pos):
        with torch.inference_mode():
            return transformer.serve_step(cfg, params, cache, tokens, pos)
    return step
