"""Training driver.

The counterpart of ``repro.launch.train``: config -> DyDD-balanced data
loader -> train step -> straggler monitor -> async checkpoints with
auto-resume, on one device (the card unless asked otherwise).  The
loader's batches are text: phi-3-vision trains on them without patches,
as the reference's driver does, and whisper, whose encoder needs frames,
is refused before any step (``ValueError``; the reference fails in its
first step with ``KeyError: 'frames'``) unless the caller of
:func:`train` gives frames (``extras``; the CLI gives none).  The
training forward runs the ``rglru_scan``, ``flash_attention`` and
``ssd_scan`` kernels and their backward kernels on the card
(:mod:`repro_torch.kernels.ops`); the optimizer is the reference's AdamW
with f32 moments.  ``--ckpt-dir`` saves and resumes ``{"params", "opt"}``
and the loader's state in the reference's on-disk format, so either
package resumes the other's run.

``train(mesh=...)`` is sharded training on a
:class:`~repro_torch.runtime.mesh.ProcessMesh` (every rank of it calls
``train``): each rank holds its blocks of the params and moments, runs
the loader with the same seed and hands the whole global batch to the
sharded step (:func:`repro_torch.runtime.steps.make_train_step`), which
takes its rows, computes tensor-parallel on "model" and gathers each
layer's blocks over their FSDP axes in the layer.  The mesh's first rank writes each checkpoint
(``CheckpointManager.save(shardings=)``); a run resumes onto the same
mesh or another mesh shape (:func:`repro_torch.runtime.elastic.remesh`).
The CLI runs one process, as the reference's does.

Weights are random, drawn on the device from a seeded generator
(:func:`repro_torch.models.transformer.init_params`; other numbers than
the reference's from the same seed), unless ``init_params`` gives them.

Usage (the card by default; ``--device cpu`` for a CPU run):
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch recurrentgemma-9b|mamba2-1.3b|olmoe-1b-7b|... [--smoke] \
      --steps 100 --seq 128 --batch 8 [--dp 4] [--ckpt-dir DIR] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.data import pipeline
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, adamw, adamw_init, make_schedule
from repro_torch.runtime import elastic
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.straggler import StragglerMonitor


def batch_on(device, tokens, labels, mask) -> dict:
    """A loader batch (numpy) as tensors on ``device``."""
    return {"tokens": torch.as_tensor(tokens, device=device),
            "labels": torch.as_tensor(labels, device=device),
            "mask": torch.as_tensor(mask, device=device)}


def train(cfg, *, steps: int, seq: int, global_batch: int, dp: int,
          ckpt_dir: str | None, ckpt_every: int = 50, lr: float = 3e-4,
          seed: int = 0, log_every: int = 10, mesh=None, device=None,
          init_params=None, extras=None):
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s newest
    checkpoint if there is one); returns (params, opt, losses of the
    steps run here).  ``init_params`` (a tree like ``init_params`` gives,
    on ``device``) replaces the random weights.  Each step accumulates
    the gradients of ``cfg.train_accum`` microbatches (Mixtral's 8), so
    ``global_batch`` must be a multiple of it.  ``extras`` (tensors on
    ``device`` with ``global_batch`` rows: whisper's ``"frames"``,
    phi-3-vision's ``"patches"``) joins every batch; whisper trains only
    with frames.  With ``mesh`` every rank of it calls ``train`` alike
    (``init_params`` and ``extras`` whole, on the rank's device, which is
    the mesh's), and the params and ``opt`` returned are this rank's
    blocks (``param_specs`` and ``opt_specs`` on the mesh)."""
    extras = extras or {}
    if cfg.is_encoder_decoder and "frames" not in extras:
        # The reference's loader batch has no frames either: its trainer
        # fails in the first step with KeyError: 'frames'.
        raise ValueError(
            f"{cfg.name}: the loader's batches hold tokens only, and the "
            f"encoder reads batch['frames']; give train() frames "
            f"(extras={{'frames': ...}})")
    dev = device_mod.resolve(device) if mesh is None else mesh.device
    opt_cfg = AdamWConfig(lr=lr, accum_steps=cfg.train_accum)
    schedule = make_schedule("cosine", lr, warmup_steps=max(steps // 20, 1),
                             total_steps=steps)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, lr_schedule=schedule,
                                        mesh=mesh)

    loader = pipeline.BalancedLoader(
        vocab_size=cfg.vocab_size, dp=dp,
        batch_per_shard=global_batch // dp, seq=seq, seed=seed)

    params = (transformer.init_params(cfg, seed, device=dev)
              if init_params is None else init_params)
    shardings = None
    if mesh is not None:
        with sharding.use_mesh(mesh):
            pspecs = transformer.param_specs(cfg)
            shardings = {
                "params": sharding.named_shardings(mesh, pspecs),
                "opt": sharding.named_shardings(mesh,
                                                steps_mod.opt_specs(cfg))}
        params = adamw.tree_map(
            lambda p, sh: sharding.local_block(p, sh).clone(), params,
            shardings["params"])
    opt = adamw_init(params)
    start_step = 0

    mgr = None
    if ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(ckpt_dir, keep=3)
        restored = _restore(mgr, cfg, mesh, params, opt)
        if restored is not None:
            params, opt, manifest = restored
            loader.load_state_dict(manifest["metadata"]["loader"])
            start_step = manifest["step"]
            print(f"resumed from step {start_step}")

    monitor = StragglerMonitor()
    losses = []
    for s in range(start_step, steps):
        batch = {**batch_on(dev, *loader.next_batch()), **extras}
        t0 = time.perf_counter()
        loss, params, opt = step_fn(params, opt, batch)
        loss = float(loss)
        monitor.record(time.perf_counter() - t0)
        losses.append(loss)
        if s % log_every == 0 or s == steps - 1:
            st = loader.last_stats
            print(f"step {s:5d} loss {loss:8.4f} "
                  f"balance E {st.efficiency_before:.3f}->"
                  f"{st.efficiency_after:.3f} moved {st.docs_moved}")
        if mgr and (s + 1) % ckpt_every == 0:
            mgr.save({"params": params, "opt": opt}, step=s + 1,
                     metadata={"loader": loader.state_dict()},
                     blocking=False, shardings=shardings)
    if mgr:
        mgr.save({"params": params, "opt": opt}, step=steps,
                 metadata={"loader": loader.state_dict()}, blocking=True,
                 shardings=shardings)
        mgr.wait()
        mgr.close()
    return params, opt, losses


def _restore(mgr, cfg, mesh, params, opt):
    """(params, opt, manifest) of the newest verified checkpoint, each
    rank's blocks on a mesh (whatever mesh wrote it), or None."""
    if mesh is None:
        restored = mgr.restore_latest(like={"params": params, "opt": opt})
        if restored is None:
            return None
        tree, manifest = restored
        return tree["params"], tree["opt"], manifest
    try:
        return elastic.remesh(cfg, mgr.directory, mesh,
                              dtype=adamw.leaves(params)[0].dtype)
    except FileNotFoundError:
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    _, _, losses = train(cfg, steps=args.steps, seq=args.seq,
                         global_batch=args.batch, dp=args.dp,
                         ckpt_dir=args.ckpt_dir, lr=args.lr,
                         seed=args.seed, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
