"""Streaming DD-KF assimilation with online DyDD on the PyTorch/CUDA port
— a thin wrapper over the port's CLI (:mod:`repro_torch.assim.cli`), which
prints ``examples/dydd_assimilation.py``'s table.  Every flag of the
reference example that the CLI takes passes through as it is (the CLI
adds ``--device``, ``--backend`` for ``--solver shardmap``, ``--gram-mode``
and the Parareal flags).  Runs on the card unless ``--device cpu`` (no
card and no ``--device cpu`` is an error, not a fallback):

  PYTHONPATH=src python examples/dydd_assimilation_torch.py
  PYTHONPATH=src python examples/dydd_assimilation_torch.py --device cpu \\
      --n 96 --m 200 --cycles 4 --scenarios drifting_swarm   # CI smoke
  PYTHONPATH=src python examples/dydd_assimilation_torch.py \\
      --ndim 2 --nx 12 --ny 8 --pr 2 --pc 2 --m 200 --cycles 2 \\
      --scenarios rotating_swarm                             # 2D smoke
"""
from repro_torch.assim import cli


def main(argv=None) -> None:
    cli.main(argv)


if __name__ == "__main__":
    main()
