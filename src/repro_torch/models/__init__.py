"""Language-model stack: the RecurrentGemma and Mamba-2 serving slices
(``config``, ``nn``, ``rglru``, ``attention``, ``ssd``, ``transformer``)."""
