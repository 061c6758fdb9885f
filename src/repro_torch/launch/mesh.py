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

:func:`make_production_mesh` is the dry-run's mesh: 16x16 cards on
``("data", "model")``, or two such pods on ``("pod", "data",
"model")``. Nobody holds those cards: its entries are meta devices, and
the specs read only its axis names and shape. :func:`fake_device_mesh`
builds the ``DeviceMesh`` of such a mesh on a fake process group, for a
DTensor trace in one process (``repro_torch.launch.dryrun``), with
``"pod"`` and ``"data"`` merged into one mesh dim where the trace's
specs allow it.
"""
from __future__ import annotations

import contextlib
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


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple | None = None) -> Mesh:
    """16x16 = 256 cards per pod; 2 pods = 512 cards multi-pod.

    ``shape=(d, m)`` overrides the per-pod shape (the reference reads it
    from ``REPRO_MESH``), for small runs of the dry-run machinery."""
    d, m = shape if shape else (16, 16)
    dims = (2, d, m) if multi_pod else (d, m)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = np.empty(dims, dtype=object)
    devices.reshape(-1)[:] = [torch.device("meta")] * devices.size
    return Mesh(devices, axes)


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, merge_data_axes: bool = False):
    """The ``DeviceMesh`` of ``mesh`` on a fake process group of its size
    (this process is rank 0; collectives complete at once and move no
    data). The group is destroyed on exit, so the process is left with
    no process group. Raises if one already exists.

    ``merge_data_axes``: ``"pod"`` and ``"data"`` become one mesh dim,
    named ``"pod+data"``, pod-major, as a dim split over ``("pod",
    "data")`` is laid out. DTensor then splits, views and reduces such a
    dim as one, where over two mesh dims it cannot view it; only specs
    that name both axes together, or neither, can be placed on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.trace_compat import check_version, fake_store

    check_version()
    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    shape, names = mesh.devices.shape, tuple(mesh.axis_names)
    if merge_data_axes and "pod" in names:
        i = names.index("pod")
        if names[i + 1] != "data":
            raise ValueError(f"axes {names}: pod must precede data")
        shape = shape[:i] + (shape[i] * shape[i + 1],) + shape[i + 2:]
        names = names[:i] + ("pod+data",) + names[i + 2:]
    dist.init_process_group("fake", rank=0, world_size=mesh.devices.size,
                            store=fake_store())
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
