"""Entry points: the LM serving and training drivers."""
