"""AdamW with decoupled weight decay, global-norm clipping and f32
moments.

The counterpart of ``repro.optim.adamw``: params keep their dtype (bf16
on the card), ``m`` and ``v`` are f32, and a leaf's update is the
reference's arithmetic in f32 with the result cast back to the param's
dtype.  Trees are nested dicts of tensors.  ``torch.optim.AdamW`` is not
used: its bias correction and decay are ordered differently.

The update works in place (params, moments and, for clipping, the grads)
and walks each leaf in slices of ``SLICE`` elements, so that its f32
temporaries stay small beside a 1.05 B-element embedding table.
"""
from __future__ import annotations

import dataclasses

import torch

SLICE = 1 << 26   # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    accum_steps: int = 1     # gradient accumulation (microbatching)


def leaves(tree) -> list:
    """The leaves of a nested dict in the reference's flatten order
    (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``tree`` with each leaf x replaced by ``fn(x, *same leaf of rest)``,
    called in :func:`leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": step}


def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm over every leaf."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32) ** 2
          for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scales the grads in place by min(1, max_norm / norm), the factor
    cast to each grad's dtype as in the reference; returns (grads,
    norm).  ``norm`` is the grads' global norm where they are one rank's
    blocks of a sharded tree (the caller sums it over the ranks;
    :func:`global_norm` of the blocks otherwise)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _update(cfg: AdamWConfig, g, m, v, p, lr: float, bc1, bc2) -> None:
    """One slice: m, v and p updated in place."""
    g32 = g.float()
    m.mul_(cfg.b1).add_(g32, alpha=1.0 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g32, g32, value=1.0 - cfg.b2)
    del g32
    denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
    delta = torch.div(m, bc1).div_(denom)
    del denom
    p32 = p.float()
    delta.add_(p32, alpha=cfg.weight_decay)
    p.copy_(p32.sub_(delta.mul_(lr)))


def adamw_step(cfg: AdamWConfig, grads, opt_state, params,
               lr: float | None = None, norm=None):
    """One AdamW update, in place.  Returns (params, opt_state,
    grad_norm); ``grads`` are clipped in place (by ``norm``, their global
    norm, where they are blocks of a sharded tree:
    :func:`clip_by_global_norm`)."""
    lr = cfg.lr if lr is None else float(lr)
    grads, norm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    with torch.no_grad():
        for g, m, v, p in zip(leaves(grads), leaves(opt_state["m"]),
                              leaves(opt_state["v"]), leaves(params)):
            parts = zip(g.reshape(-1).split(SLICE),
                        *(x.view(-1).split(SLICE) for x in (m, v, p)))
            for gs, ms, vs, ps in parts:
                _update(cfg, gs, ms, vs, ps, lr, bc1, bc2)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, norm
