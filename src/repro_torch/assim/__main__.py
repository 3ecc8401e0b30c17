"""``python -m repro_torch.assim``: the port's assimilation CLI
(:mod:`repro_torch.assim.cli`)."""
from repro_torch.assim.cli import main

if __name__ == "__main__":
    main()
