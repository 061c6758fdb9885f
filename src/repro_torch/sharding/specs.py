"""Mesh axis helpers, copies of the JAX package's ``sharding/specs.py``.

Axes: ``"data"`` (+ optional ``"pod"``) is the batch and client axis;
``"model"`` the tensor and expert axis. They read a
:class:`repro_torch.launch.mesh.Mesh` as the reference reads a JAX mesh.

Not ported yet: the parameter, optimizer-state, batch and cache
placement rules (``param_spec``, ``params_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``).
They belong to the dry-run, the port's last slice (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import numpy as np


def mesh_axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        return int(np.prod([mesh_axis_size(mesh, n) for n in name]))
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
