"""Drivers: how a kind of traffic drives the port. A traffic file names
its driver (``"driver": "<module>"``); the driver builds the program's
objects from the configuration and the traffic, warms them, runs the
window and checks what the window's path produced against
``portbench.reference``."""
from __future__ import annotations

import dataclasses


def port_config(cfg: dict, **overrides):
    """The port's ``ModelConfig`` from a benchmark configuration file
    (its keys that are ``ModelConfig`` fields)."""
    from repro_torch.models.common import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in names}
    kw.update(overrides)
    return ModelConfig(**kw)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
