"""Sharding rules: parameter / optimizer-state / batch / cache partition
specs for every architecture on the production mesh, copies of the JAX
package's ``sharding/specs.py``.

Axes: ``"data"`` (+ optional ``"pod"``) = batch/client parallel;
``"model"`` = tensor/expert parallel. Rules are name+shape based and
*divisibility guarded*: a dim is only sharded when its size divides the
mesh axis, e.g. starcoder2's 4 KV heads stay replicated on a 16-way
model axis while its 48 Q heads shard; qwen2-moe's 60 experts don't
divide 16 so its expert weights shard on the ff dim instead
(tensor-parallel experts) whereas llama4's 16 experts shard
expert-parallel. Optimizer state (Adam m/v, f32) is additionally
ZeRO-1-sharded over the data axis on the largest still-unsharded
divisible dim.

A spec is a :class:`PartitionSpec`: a tuple with one entry a tensor dim,
each ``None`` (replicated), an axis name, or a tuple of names (the dim
split over those axes, major to minor), as the reference's
``jax.sharding.PartitionSpec``. The rules read a
:class:`repro_torch.launch.mesh.Mesh` (``axis_names`` and
``devices.shape``) and return specs, or trees of specs shaped like the
tree they place, where the reference returns ``NamedSharding`` trees.
Tree paths are the port's own walk (:func:`tree_map_with_path`): dict
keys as names, list indices as digit strings, as the reference reads
``DictKey`` and ``SequenceKey``. :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import numpy as np


class PartitionSpec(tuple):
    """``PartitionSpec("model", None)``: one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_size(mesh, name) -> int:
    if isinstance(name, (tuple, list)):
        return int(np.prod([mesh_axis_size(mesh, n) for n in name]))
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(name, 1)


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _div(size: int, n: int) -> bool:
    return n > 0 and size % n == 0


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts and lists, with
    ``path`` the tuple of keys from the root (list indices as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(path: tuple, shape: tuple, mesh,
               expert_2d: bool = False) -> PartitionSpec:
    """PartitionSpec for one parameter, identified by its tree path.

    ``expert_2d``: additionally shard expert ff dims over the data axes
    (FSDP-style weight sharding for very large MoE serving)."""
    tp = mesh_axis_size(mesh, "model")
    dax = data_axes(mesh)
    dsize = mesh_axis_size(mesh, dax)
    daxis = dax if len(dax) > 1 else dax[0]
    names = [str(k) for k in path]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""

    # stacked layer params have a leading L dim; list stacks have an
    # integer path element instead.
    stacked = False
    if "layers" in names:
        i = names.index("layers")
        stacked = not (len(names) > i + 1 and names[i + 1].isdigit())

    off = 1 if stacked else 0
    rank = len(shape) - off          # logical (per-layer) rank

    def spec(*dims):
        assert len(dims) == rank, (name, shape, dims)
        return P(*([None] * off + list(dims)))

    def tp_if(size):
        return "model" if _div(size, tp) else None

    if name == "embed":
        return P(tp_if(shape[0]), None)
    if name == "lm_head":
        return P(None, tp_if(shape[1]))

    if parent == "moe" and name in ("w_gate", "w_up", "w_down") and rank == 3:
        E = shape[off]
        ff_dim = 2 if name in ("w_gate", "w_up") else 1
        if _div(E, tp):                          # expert parallel
            dims = ["model", None, None]
            if expert_2d and _div(shape[off + ff_dim], dsize):
                dims[ff_dim] = daxis             # + FSDP over data
            return spec(*dims)
        dims = [None, None, None]
        dims[ff_dim] = tp_if(shape[off + ff_dim])  # tensor-parallel experts
        return spec(*dims)
    if name == "router":
        return spec(*([None] * rank))

    if name in ("wq", "wk", "wv"):
        if rank == 3:    # attention projections (d, H|G, hd): shard heads
            return spec(None, tp_if(shape[off + 1]), None)
        if rank == 2:    # mlstm square projections (inner, inner)
            return spec(None, tp_if(shape[off + 1]))
    if name == "wo" and rank == 3:
        return spec(tp_if(shape[off]), None, None)

    if name in ("w_gate", "w_up", "w_ff_gate", "w_ff_up", "w_in", "w1") \
            and rank == 2:           # column parallel
        return spec(None, tp_if(shape[off + 1]))
    if name in ("w_down", "w_ff_down", "w_out", "w2") and rank == 2:
        return spec(tp_if(shape[off]), None)      # row parallel

    return P(*([None] * len(shape)))   # norms, biases, gates, convs: replicate


def params_shardings(params, mesh, expert_2d: bool = False):
    """Spec tree matching a params tree (of real, fake or meta tensors)."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                      expert_2d=expert_2d), params)


def opt_state_shardings(params, mesh):
    """Adam state: m/v shard like params plus ZeRO-1 over the data axis on
    the largest remaining divisible dim; count replicated."""
    dax = data_axes(mesh)
    dp_total = mesh_axis_size(mesh, dax)

    def zero1(path, leaf):
        shape = tuple(leaf.shape)
        spec = list(param_spec(path, shape, mesh))
        spec += [None] * (len(shape) - len(spec))
        # pick the largest unsharded dim divisible by the full data size
        best, best_size = None, 0
        for i, (s, dim) in enumerate(zip(spec, shape)):
            if s is None and _div(dim, dp_total) and dim > best_size:
                best, best_size = i, dim
        if best is not None:
            spec[best] = dax if len(dax) > 1 else dax[0]
        return P(*spec)

    m = tree_map_with_path(zero1, params)
    return {"count": P(), "m": m, "v": m}


def batch_shardings(batch, mesh, batch_sharded: bool = True):
    """Batch leaves shard dim0 over (pod, data) when divisible."""
    dax = data_axes(mesh)
    n = mesh_axis_size(mesh, dax)
    axis = dax if len(dax) > 1 else dax[0]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if batch_sharded and shape and _div(shape[0], n):
            return P(axis, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))
    return tree_map_with_path(one, batch)


def cache_shardings(cache, mesh, batch: int, seq_over_model: bool = False):
    """Decode caches: batch dim over data axes when divisible; otherwise
    (long_500k, B=1) shard the KV sequence axis over "data" (the
    flash-decoding layout). SSM states follow the batch rule.

    ``seq_over_model=True``: additionally shard the cache sequence axis
    over "model" when KV heads don't divide it (GQA head counts of 4-20
    never divide a 16-way model axis, so without this the model axis
    holds a full cache replica per shard).
    """
    dax = data_axes(mesh)
    n = mesh_axis_size(mesh, dax)
    axis = dax if len(dax) > 1 else dax[0]
    tp = mesh_axis_size(mesh, "model")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        # kv k/v: (L, B, W, G, hd) or (B, W, G, hd)
        if name in ("k", "v") and len(shape) >= 4:
            b_dim = len(shape) - 4
            w_dim = b_dim + 1
            g_dim = b_dim + 2
            spec = [None] * len(shape)
            if _div(shape[b_dim], n) and shape[b_dim] > 1:
                spec[b_dim] = axis
            elif _div(shape[w_dim], mesh_axis_size(mesh, "data")):
                spec[w_dim] = "data"     # sequence-sharded cache (B too small)
            if _div(shape[g_dim], tp):
                spec[g_dim] = "model"
            elif seq_over_model and spec[w_dim] is None \
                    and _div(shape[w_dim], tp):
                spec[w_dim] = "model"    # flash-decoding over the model axis
            return P(*spec)
        if name == "pos":
            return P(*([None] * len(shape)))
        # ssm states / conv caches: (L, B, ...) - batch over data if divisible
        spec = [None] * len(shape)
        for i, dim in enumerate(shape[:2]):
            if _div(dim, n) and dim > 1:
                spec[i] = axis
                break
        return P(*spec)

    return tree_map_with_path(one, cache)


def replicated(tree, mesh):
    return tree_map_with_path(
        lambda path, leaf: P(*([None] * len(leaf.shape))), tree)


def placements(spec, device_mesh) -> list:
    """DTensor placements on ``device_mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``) for one spec: ``Shard(dim)`` on every mesh dim
    of more than one device that names the tensor dim ``dim``,
    ``Replicate()`` elsewhere (a split one way is no split, and DTensor
    plans faster without it). A dim over ``("pod", "data")`` is split
    over both mesh dims, the first the major one, as JAX lays it out, or
    over the one mesh dim ``"pod+data"`` that merges them; a spec that
    names only one of a merged dim's axes raises."""
    from torch.distributed.tensor import Replicate, Shard

    parts = [tuple(n.split("+")) for n in device_mesh.mesh_dim_names]
    out = [Replicate()] * len(parts)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = set(entry if isinstance(entry, tuple) else (entry,))
        unknown = axes.difference(*parts)
        if unknown:
            raise ValueError(f"spec {spec} names {sorted(unknown)}, not "
                             f"axes of {device_mesh.mesh_dim_names}")
        for i, axis_parts in enumerate(parts):
            hit = axes & set(axis_parts)
            if hit and hit != set(axis_parts):
                raise ValueError(f"spec {spec} splits dim {dim} over "
                                 f"{sorted(hit)} but not over the rest of "
                                 f"mesh dim {'+'.join(axis_parts)!r}")
            if hit and device_mesh.size(i) > 1:
                out[i] = Shard(dim)
    return out
