"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in ~50 lines.

Non-uniform observations -> DyDD load balancing -> DD-KF distributed solve
(the ``gram`` and Schwarz kernels on the card), validated against the
sequential KF estimate (error_DD-DA ~ 1e-14).  The sizes and observations
are ``examples/quickstart.py``'s; the CLS problem's truth and noise come
from a numpy generator, since torch cannot reproduce ``jax.random``.
Runs on the card unless ``--device cpu`` (no card and no ``--device cpu``
is an error, not a fallback):

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import cls, dd, ddkf, dydd, kalman
from repro_torch.data import observations


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                    "the CPU)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    n, m, p = 512, 1200, 8

    # 1. A CLS state-estimation problem with spatially clustered (sparse,
    #    non-uniform) observations — the setting DyDD exists for.
    obs = observations.make_observations(m, kind="clustered", seed=42)
    prob = cls.local_problem(np.random.default_rng(0), n, obs, device=dev)

    # 2. Static uniform DD would be badly unbalanced:
    static_counts = np.histogram(obs, bins=p, range=(0, 1))[0]
    print(f"static DD loads:   {static_counts}  "
          f"(E = {dydd.balance_ratio(static_counts):.3f})")

    # 3. DyDD: DD step + diffusion scheduling + boundary migration.
    res = dydd.dydd_1d(obs, p)
    print(f"after DyDD:        {res.loads_final}  "
          f"(E = {res.efficiency:.3f}, {res.rounds} scheduling rounds, "
          f"{res.total_movement} obs moved)")

    # 4. DD-KF: the distributed Kalman/CLS solve on the balanced DD.
    dec = dd.decompose_1d(n, res.boundaries)
    packed = ddkf.pack(prob, dec)
    x_ddkf = ddkf.solve_vmapped(packed, iters=120)

    # 5. Validate against the sequential KF (the paper's reference).
    x_kf = kalman.solve_cls_sequential(prob, block=50)
    err = float(torch.linalg.norm(x_ddkf - x_kf))
    print(f"error_DD-DA = ||x_KF - x_DD-KF|| = {err:.2e}   "
          f"(paper reports ~1e-11 at n=2048) on {dev}")
    if not err < 1e-8:
        raise RuntimeError(f"error_DD-DA {err:.2e} is not below 1e-8")
    return err


if __name__ == "__main__":
    main()
