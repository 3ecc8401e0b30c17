"""Architecture configs, as in ``repro.configs``: the same ``ARCHS`` and
``ARCH_IDS``.  The port serves and trains all ten (``PORTED``): the
hybrid, SSD and uniform attention families, whisper's encoder-decoder
(trained through ``runtime.steps.make_train_step`` on batches that hold
its frames) and the phi3-vision stub."""
from __future__ import annotations

import importlib

ARCHS = (
    "recurrentgemma_9b",
    "gemma_7b",
    "yi_6b",
    "gemma3_1b",
    "glm4_9b",
    "whisper_large_v3",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "phi3_vision_4_2b",
    "mamba2_1_3b",
)

# CLI ids (dashes) -> module names.
ARCH_IDS = {a.replace("_", "-"): a for a in ARCHS}
ARCH_IDS.update({a: a for a in ARCHS})
# canonical ids with dots / odd hyphenation
ARCH_IDS.update({
    "mamba2-1.3b": "mamba2_1_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "phi3-vision-4.2b": "phi3_vision_4_2b",
})

PORTED = ("recurrentgemma_9b", "mamba2_1_3b", "yi_6b", "gemma_7b",
          "glm4_9b", "gemma3_1b", "olmoe_1b_7b", "mixtral_8x22b",
          "whisper_large_v3", "phi3_vision_4_2b")


def _module(arch: str):
    name = ARCH_IDS[arch]
    if name not in PORTED:
        raise NotImplementedError(
            f"{arch}: the port serves {', '.join(PORTED)} only")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    """Full-size ModelConfig for an arch id (dashes or underscores)."""
    return _module(arch).config()


def get_smoke_config(arch: str):
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).smoke_config()
