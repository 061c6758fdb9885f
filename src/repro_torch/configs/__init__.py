"""Architecture registry, a data copy of the JAX package's
``configs``: every architecture is a selectable config (``--arch
<id>``). Each file pins the exact shape and cites its source in
``source=``. The port's transformer builds and serves every one of
them: dense, MoE, SSM, hybrid, the vision prefix and the
encoder-decoder."""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = (
    "starcoder2-15b",
    "qwen2-moe-a2.7b",
    "mistral-nemo-12b",
    "llama4-scout-17b-a16e",
    "internlm2-1.8b",
    "hymba-1.5b",
    "smollm-360m",
    "internvl2-26b",
    "xlstm-125m",
    "whisper-large-v3",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.config()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
