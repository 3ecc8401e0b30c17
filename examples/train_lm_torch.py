"""End-to-end example on the PyTorch/CUDA port: train a ~100M-param
gemma3-family model for a few hundred steps with the full stack —
DyDD-balanced data loading, AdamW + cosine schedule, straggler
monitoring, checkpoints with auto-resume from ``--ckpt-dir``.

The flags and the configs are ``examples/train_lm.py``'s.  Runs on the
card unless ``--device cpu`` (no card and no ``--device cpu`` is an
error, not a fallback):

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--tiny]
  PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu

--tiny (CI mode) shrinks the model so the example completes in seconds.
A second run with the same ``--ckpt-dir`` resumes from its newest
checkpoint and trains the steps up to ``--steps``.
"""
import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.launch.train import train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = configs.get_smoke_config("gemma3-1b")
        seq, batch, dp = 64, 8, 4
    else:
        # ~100M params: gemma3-1b family at reduced width/depth
        cfg = configs.get_config("gemma3-1b").scaled(
            num_layers=12, d_model=512, num_heads=4, num_kv_heads=1,
            head_dim=128, d_ff=2048, vocab_size=32768, window=256,
            dtype="float32", fsdp=False, remat="none", loss_chunk=0,
            attn_q_chunk=0, scan_layers=True)
        seq, batch, dp = 256, 8, 4
        n = cfg.param_count()
        print(f"model: {cfg.name}-family, {n/1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_lm")
    _, _, losses = train(cfg, steps=args.steps, seq=seq,
                         global_batch=batch, dp=dp, ckpt_dir=ckpt_dir,
                         ckpt_every=100, lr=3e-4, log_every=20,
                         device=args.device)
    if not losses:
        print(f"nothing to train: {ckpt_dir} holds step {args.steps}")
        return losses
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps); checkpoints in {ckpt_dir}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training should reduce the loss")
    return losses


if __name__ == "__main__":
    main()
