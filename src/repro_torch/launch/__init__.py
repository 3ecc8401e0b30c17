"""Entry points: the LM serving driver."""
