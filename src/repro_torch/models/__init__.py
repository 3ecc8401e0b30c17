"""Language-model stack: the RecurrentGemma serving slice (``config``,
``nn``, ``rglru``, ``attention``, ``transformer``)."""
