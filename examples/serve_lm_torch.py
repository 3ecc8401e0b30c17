"""Serve a small model on the PyTorch/CUDA port with batched requests:
prefill + lock-step decode with per-request lengths, greedy decoding.

The flags and the request plan (numpy, seed 0) are
``examples/serve_lm.py``'s; the weights are the port's own random draw.
Runs on the card unless ``--device cpu`` (no card and no ``--device cpu``
is an error, not a fallback):

  PYTHONPATH=src python examples/serve_lm_torch.py [--arch gemma3-1b]
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.models import transformer


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = configs.get_smoke_config(args.arch)
    params = transformer.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        1, cfg.vocab_size,
                        int(rng.integers(4, 32))).astype(np.int32),
                    max_new=int(rng.integers(8, args.max_new + 1)))
            for i in range(args.batch)]
    print(f"{len(reqs)} requests, prompt lens "
          f"{[len(r.prompt) for r in reqs]}, max_new "
          f"{[r.max_new for r in reqs]}")

    reqs, stats = serve_batch(cfg, params, reqs, max_seq=64, greedy=True)
    for r in reqs:
        print(f"  req {r.rid}: generated {len(r.out)} tokens "
              f"{r.out[:10]}{'...' if len(r.out) > 10 else ''}")
    print(f"prefill {stats['prefill_s']*1e3:.0f} ms, "
          f"decode {stats['decode_s']*1e3:.0f} ms "
          f"({stats['tokens_per_s']:.1f} tok/s on {dev})")
    return reqs


if __name__ == "__main__":
    main()
