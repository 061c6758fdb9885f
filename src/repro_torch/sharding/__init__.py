"""Mesh axis helpers (copies of the JAX package's ``sharding``)."""
from .specs import data_axes, mesh_axis_size
