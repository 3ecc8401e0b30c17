"""Language-model stack: the RecurrentGemma and Mamba-2 slices, serving
and training (``config``, ``nn``, ``rglru``, ``attention``, ``ssd``,
``transformer``)."""
