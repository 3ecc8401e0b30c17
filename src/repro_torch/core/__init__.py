"""Core library: CLS, DD-CLS decomposition, DyDD (1D/2D), DD-KF, and the
Domain layer (interval / shelf / k-d tree)."""
