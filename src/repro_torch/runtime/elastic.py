"""Elastic scaling: resume a run on another population of ranks.

The counterpart of ``repro.runtime.elastic``.  Checkpoints hold whole
arrays, so scaling a training run is: lay the new mesh out, recompute
the partition specs, restore each rank's blocks (:func:`remesh`).  The
global batch is re-split over the new data-parallel width by the
training step itself.

The assimilation half: :func:`resume_assim_engine` restores an
:class:`~repro_torch.assim.engine.AssimilationEngine` from its snapshot
(written by either package) and, when the requested subdomain count p′
differs from the saved p, *re-derives the domain decomposition for p′*
from the load history the journal recorded
(:func:`remesh_assim_domain`): the k-d tree warm-starts a rebuild from a
synthetic density cloud, the interval/shelf tilings re-cut their edges
at the quantiles of the journalled piecewise-constant observation
density.  Either way the stream continues from the saved cursor — no
completed cycle is ever replayed.

A ``solver="shardmap"`` snapshot resumes onto a process mesh: every
rank of the new process group calls :func:`resume_assim_engine`, at the
saved p or at a new one (the engine then runs on a mesh of new-p ranks
shaped by ``domain.mesh_axes()``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import domain as domain_mod
from repro_torch.core import kdtree as kdtree_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.sharding import named_shardings


def remesh(cfg: ModelConfig, checkpoint_dir: str, new_mesh, dtype=None):
    """Restore (params, opt_state, manifest) onto ``new_mesh`` (a
    ``ProcessMesh``): each rank gets its blocks of the newest verified
    checkpoint under ``param_specs`` and ``opt_specs`` there, on its
    device; params in ``dtype`` (default ``cfg.dtype``), moments f32.
    Every rank of the mesh calls it.  Raises FileNotFoundError if no
    valid checkpoint exists (the caller then cold-starts)."""
    with sharding.use_mesh(new_mesh):
        shapes = transformer.param_shapes(cfg, dtype=dtype)
        pspecs = transformer.param_specs(cfg)
        ospecs = steps_mod.opt_specs(cfg)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    like = {"params": shapes,
            "opt": {"m": adamw.tree_map(f32, shapes),
                    "v": adamw.tree_map(f32, shapes),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    shard_tree = {"params": named_shardings(new_mesh, pspecs),
                  "opt": named_shardings(new_mesh, ospecs)}
    path = ckpt.latest_checkpoint(checkpoint_dir)
    if path is None:
        raise FileNotFoundError(checkpoint_dir)
    tree, manifest = ckpt.restore_pytree(path, like=like,
                                         shardings=shard_tree)
    return tree["params"], tree["opt"], manifest


def rebalanced_edges(edges, loads, new_p: int) -> np.ndarray:
    """Re-cut a 1D tiling for a new subdomain count from its load
    history: the journalled ``loads`` define a piecewise-constant
    observation density over the old ``edges``; the new edges sit at
    the ``new_p``-quantiles of that density (piecewise-linear inverse
    CDF via ``np.interp``).  Zero total mass falls back to uniform."""
    edges = np.asarray(edges, np.float64)
    loads = np.asarray(loads, np.float64)
    total = float(loads.sum())
    if total <= 0.0:
        return np.linspace(edges[0], edges[-1], new_p + 1)
    cum = np.concatenate([[0.0], np.cumsum(loads)])
    out = np.interp(np.linspace(0.0, total, new_p + 1), cum, edges)
    out[0], out[-1] = edges[0], edges[-1]
    return out


def _merged_x_density(x_edges: np.ndarray, cell_loads: np.ndarray,
                      weights: np.ndarray) -> tuple:
    """(breakpoints, per-segment masses) of the y-overlap-weighted
    combination of the old strips' x densities — the 1D density a new
    strip sees when it spans fractions ``weights[r]`` of old strips."""
    bps = np.unique(np.asarray(x_edges, np.float64).reshape(-1))
    seg_lo, seg_hi = bps[:-1], bps[1:]
    dens = np.zeros(seg_lo.shape[0])
    for r in range(x_edges.shape[0]):
        if weights[r] <= 0.0:
            continue
        for c in range(cell_loads.shape[1]):
            lo, hi = x_edges[r, c], x_edges[r, c + 1]
            if hi <= lo:
                continue
            inside = (seg_lo >= lo) & (seg_hi <= hi)
            dens[inside] += weights[r] * cell_loads[r, c] / (hi - lo)
    return bps, dens * (seg_hi - seg_lo)


def _shelf_grid(p: int, pr_old: int, pr: Optional[int],
                pc: Optional[int]) -> tuple:
    """(pr', pc') for a p-subdomain shelf: explicit values win, else the
    largest divisor of p not exceeding the old strip count (shrinking p
    keeps the strip granularity rather than collapsing to one row)."""
    if pr is not None or pc is not None:
        pr = pr if pr is not None else p // pc
        pc = pc if pc is not None else p // pr
        if pr * pc != p:
            raise ValueError(f"pr*pc = {pr}*{pc} != p = {p}")
        return pr, pc
    best = 1
    for d in range(1, min(pr_old, p) + 1):
        if p % d == 0:
            best = d
    return best, p // best


def remesh_assim_domain(meta: dict, flat: dict, p: int,
                        pr: Optional[int] = None,
                        pc: Optional[int] = None) -> tuple:
    """Derive a (domain, config) pair for a new subdomain count from an
    engine snapshot's metadata + array tree.

    The observation-count history lives in the journal: the last
    record's post-repartition ``loads`` against the saved boundary
    state are the best density estimate the snapshot holds, and every
    domain kind re-tiles from them — interval/shelf by quantile
    re-cutting (:func:`rebalanced_edges`), the k-d tree by a
    warm-started rebuild over a synthetic density cloud (one point per
    journalled observation, placed on the old leaf's mesh-cell
    centres).  With no journalled cycles the new domain starts from its
    default even tiling.  Like the reference, a rebuilt shelf takes the
    default ``max_rounds`` (``describe()`` does not record it).
    """
    from repro_torch.assim.engine import config_from_meta

    desc = meta["domain"]
    kind = desc["kind"]
    saved_cfg = config_from_meta(meta)
    records = meta.get("journal", {}).get("records", [])
    loads = (np.asarray(records[-1]["loads"], np.float64)
             if records else None)

    if kind == "interval1d":
        cfg = dataclasses.replace(saved_cfg, p=p)
        if loads is None:
            return domain_mod.Interval1D(n=desc["n"], p=p), cfg
        edges = rebalanced_edges(np.asarray(flat["domain/boundaries"]),
                                 loads, p)
        return domain_mod.Interval1D(n=desc["n"], p=p,
                                     boundaries=edges), cfg

    if kind == "shelf2d":
        new_pr, new_pc = _shelf_grid(p, desc["pr"], pr, pc)
        cfg = dataclasses.replace(saved_cfg, p=p, pr=new_pr, pc=new_pc)
        dom = domain_mod.ShelfTiling2D(nx=desc["nx"], ny=desc["ny"],
                                       pr=new_pr, pc=new_pc)
        if loads is None:
            return dom, cfg
        y_edges = np.asarray(flat["domain/y_edges"], np.float64)
        x_edges = np.asarray(flat["domain/x_edges"], np.float64)
        cell_loads = loads.reshape(desc["pr"], desc["pc"])
        new_y = rebalanced_edges(y_edges, cell_loads.sum(axis=1), new_pr)
        new_x = np.empty((new_pr, new_pc + 1))
        for s in range(new_pr):
            lo, hi = new_y[s], new_y[s + 1]
            # Fraction of each old strip the new strip covers in y.
            over = (np.minimum(hi, y_edges[1:])
                    - np.maximum(lo, y_edges[:-1]))
            spans = np.maximum(y_edges[1:] - y_edges[:-1], 1e-300)
            w = np.clip(over, 0.0, None) / spans
            bps, masses = _merged_x_density(x_edges, cell_loads, w)
            new_x[s] = rebalanced_edges(bps, masses, new_pc)
        dom.load_state({"y_edges": new_y, "x_edges": new_x,
                        "y_tie_ranks": np.zeros(max(new_pr - 1, 0),
                                                np.int64),
                        "x_tie_ranks": np.zeros((new_pr,
                                                 max(new_pc - 1, 0)),
                                                np.int64)})
        return dom, cfg

    if kind == "kdtree":
        cfg = dataclasses.replace(saved_cfg, p=p)
        dom = kdtree_mod.KDTreeDomain(nx=desc["nx"], ny=desc["ny"], p=p)
        if loads is None or loads.sum() <= 0:
            return dom, cfg
        old = kdtree_mod.KDTreeDomain(nx=desc["nx"], ny=desc["ny"],
                                      p=desc["p"],
                                      rects=np.asarray(
                                          flat["domain/rects"]))
        pts = []
        for i, rect in enumerate(old.rects):
            li = int(loads[i])
            if li <= 0:
                continue
            ix0, ix1, iy0, iy1 = old._cell_ranges(rect)
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            cx = (np.arange(ix0, ix1) + 0.5) / desc["nx"]
            cy = (np.arange(iy0, iy1) + 0.5) / desc["ny"]
            grid = np.stack(
                [np.repeat(cx, cy.size), np.tile(cy, cx.size)], axis=1)
            # Cycle the leaf's cell centres until the leaf's journalled
            # mass is reproduced.
            pts.append(np.resize(grid, (li, 2)))
        if pts:
            dom.rebalance(np.concatenate(pts, axis=0))
        return dom, cfg

    raise ValueError(f"cannot remesh domain kind {kind!r}")


def resume_assim_engine(checkpoint: str, *, p: Optional[int] = None,
                        pr: Optional[int] = None,
                        pc: Optional[int] = None, device=None,
                        mesh=None, mesh_axis=None, forecast=None,
                        straggler_config=None, chaos=None) -> tuple:
    """Restore an assimilation engine on ``device`` (elastically if
    ``p`` differs) and its stream continuation.

    ``checkpoint`` is a checkpoint directory (latest verified step wins;
    torn checkpoints are skipped by hash verification) or a specific
    ``step_XXXX`` path.  With ``p`` omitted or equal to the saved
    subdomain count this is an exact bitwise resume; otherwise the
    domain is re-derived for the new p (:func:`remesh_assim_domain`)
    while truth/rng/analysis/journal/cursor carry over.  Returns
    ``(engine, stream)`` — ``stream`` is the fast-forwarded
    :class:`~repro_torch.assim.streams.ResumableStream` (None if the
    snapshot was taken without a cursor-bearing stream); no completed
    cycle is replayed either way.

    The solver comes from the snapshot's config.  A ``solver="shardmap"``
    engine resumes on ``mesh``/``mesh_axis`` (default: a mesh over every
    rank of the process group, shaped like the new domain's processor
    graph), which must hold one rank per subdomain of the new p; every
    rank calls this with the same arguments.
    """
    from repro_torch.assim.engine import AssimilationEngine

    path = checkpoint
    if not os.path.basename(path).startswith("step_"):
        path = ckpt.latest_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(f"no verified checkpoint under "
                                    f"{checkpoint}")
    kw = dict(mesh=mesh, mesh_axis=mesh_axis, forecast=forecast,
              straggler_config=straggler_config, chaos=chaos)
    flat, manifest = ckpt.restore_pytree(path)
    meta = manifest["metadata"]
    saved_p = int(meta["domain"]["p"])
    if p is None or (p == saved_p and pr is None and pc is None):
        eng = AssimilationEngine.restore(path, device, **kw)
    else:
        domain, cfg = remesh_assim_domain(meta, flat, p, pr=pr, pc=pc)
        eng = AssimilationEngine.restore(path, device, config=cfg,
                                         domain=domain, **kw)
    return eng, eng.resume_stream()
