"""Device meshes for the port.

A :class:`Mesh` is the part of a ``jax.sharding.Mesh`` that the port
reads: ``axis_names`` and ``devices``, a numpy array of
``torch.device`` with one axis per name. ``repro_torch.sharding.specs``
reads it as the JAX package reads a JAX mesh.

:func:`make_host_mesh` is the reference's host mesh: every visible CUDA
device on ``"data"``. Where the reference forces N host devices through
an environment variable, the port takes explicit arguments: ``shards``
entries of one ``device``, so the tests split a round over N shards of
the CPU and the one-card machine over N shards of ``cuda:0``.

``make_production_mesh`` is not ported: it belongs to the dry-run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray              # torch.device entries, one axis a name
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_host_mesh(device=None, shards: int | None = None) -> Mesh:
    """One-host mesh, shape ``(n, 1)`` on axes ``("data", "model")``.

    With neither argument: every visible CUDA device on ``"data"``
    (raises without CUDA). With ``device`` or ``shards``: ``shards``
    (default 1) entries of that one device (default ``cuda``), e.g.
    ``make_host_mesh("cpu", 4)`` or ``make_host_mesh("cuda:0", 2)``.
    """
    if shards is not None and shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    dev = _indexed(resolve_device(device))
    if device is None and shards is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev] * (shards or 1)
    arr = np.empty((len(devs), 1), dtype=object)
    arr[:, 0] = devs
    return Mesh(arr, ("data", "model"))
