"""Device and dtype resolution for the PyTorch port.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` resolves to ``cuda``, and a missing card is an
error that names the way out (``device="cpu"``) instead of a silent
fallback.  float64 is the dtype of the whole DA path.
"""
from __future__ import annotations

import torch

DTYPE = torch.float64


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run on the CPU")
    return dev


def block(value):
    """Wait until the device work that produced ``value`` (a tensor or a
    tuple/list of tensors) has finished; returns ``value``.

    On CUDA this records an event on the current stream and waits for it,
    so a worker thread that packs while the main thread solves waits for
    its own work (and what precedes it in the stream), not for a whole
    device sync.  CPU tensors are ready when they exist."""
    leaves = value if isinstance(value, (tuple, list)) else (value,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    return value
