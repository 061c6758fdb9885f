"""Tree checkpointing: msgpack + zstd, with step rotation.

The JAX package's file format, so files written by either package load
in the other. Layout: ``<dir>/step_<n>.ckpt``, each file a msgpack map
``{"keys": [...], "leaves": [{"dtype", "shape", "data"}]}``, zstd-
compressed when the optional ``zstandard`` module is importable and raw
otherwise; restore tells the two apart by the zstd frame magic, so
compressed and uncompressed files interoperate. Arrays round-trip
exactly (raw little-endian bytes); bfloat16 is stored through a uint16
view.

Trees are nested dicts, lists and tuples of tensors or numpy arrays
(``None`` is an empty subtree, as in JAX). A leaf's key is the "/"-joined
path of dict keys and sequence indices, dict keys visited in sorted
order: the keys and leaf order of ``jax.tree_util`` on the same nesting,
letter for letter. The msgpack encoding is the port's own
(:mod:`.msgpack_codec`), byte for byte that of ``msgpack.packb(...,
use_bin_type=True)``.
"""
from __future__ import annotations

import os
import re
import warnings

import numpy as np
import torch

from . import msgpack_codec

try:
    import zstandard
except ModuleNotFoundError:      # optional: fall back to uncompressed
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _flatten(tree, prefix: tuple = ()):
    """(paths, leaves) in JAX's order: dict keys sorted, sequences in
    order, ``None`` holding no leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for k, v in items:
        p, l = _flatten(v, prefix + (k,))
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken, in :func:`_flatten`
    order, from the iterator ``leaves``; dicts keep ``like``'s key
    order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        if isinstance(like, list):
            return out
        return type(like)(*out) if hasattr(like, "_fields") \
            else type(like)(out)
    return next(leaves)


def _paths(tree):
    paths, leaves = _flatten(tree)
    return ["/".join(str(k) for k in p) for p in paths], leaves


def _to_numpy(x) -> np.ndarray:
    """A leaf on the host as numpy; bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _leaf_to_record(x) -> dict:
    arr = _to_numpy(x)
    return {"dtype": _dtype_name(x), "shape": list(arr.shape),
            "data": arr.tobytes()}          # C order, whatever the strides


def _record_to_numpy(rec: dict):
    """Exact-dtype leaf: a numpy array, except that a ``"bfloat16"``
    record (numpy has no bfloat16 without ``ml_dtypes``) comes back as a
    CPU ``torch.bfloat16`` tensor viewed from its uint16 bits."""
    shape = tuple(rec["shape"])
    if rec["dtype"] == "bfloat16":
        raw = np.frombuffer(rec["data"], np.uint16).reshape(shape).copy()
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(rec["data"],
                         np.dtype(rec["dtype"])).reshape(shape).copy()


def _record_to_leaf(rec: dict, like=None) -> torch.Tensor:
    """A record as a tensor on ``like``'s device (CPU when ``like`` is
    not a tensor)."""
    arr = _record_to_numpy(rec)
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def save(path: str, tree) -> None:
    keys, leaves = _paths(tree)
    payload = {"keys": keys, "leaves": [_leaf_to_record(x) for x in leaves]}
    packed = msgpack_codec.packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if zstandard is not None:
        packed = zstandard.ZstdCompressor(level=3).compress(packed)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packed)
    os.replace(tmp, path)  # atomic


def _read_payload(path: str) -> dict:
    with open(path, "rb") as f:
        packed = f.read()
    if packed[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise ModuleNotFoundError(
                f"{path} is zstd-compressed but the optional 'zstandard' "
                "module is not installed")
        packed = zstandard.ZstdDecompressor().decompress(packed)
    return msgpack_codec.unpackb(packed)


def restore_dict(path: str) -> dict:
    """Structure-free restore: the stored leaves as a flat ``{key: numpy
    array}`` mapping (keys are the "/"-joined tree paths), with dtypes
    preserved exactly; a bfloat16 leaf is a CPU ``torch.bfloat16``
    tensor (see :func:`_record_to_numpy`).

    Unlike :func:`restore` this needs no ``like`` tree, so it fits
    payloads whose array shapes are unknowable a priori — e.g. a
    ``core.lifecycle.TaskState`` whose pending-schedule matrices vary
    per period (``lifecycle.load_state``).
    """
    payload = _read_payload(path)
    return {k: _record_to_numpy(rec)
            for k, rec in zip(payload["keys"], payload["leaves"])}


# key sets already warned about this process: a long-running service
# restoring the same state layout every period warns once per layout
_NARROWED_WARNED: set[frozenset] = set()


def reset_narrowing_warnings() -> None:
    """Forget which narrowed-key sets were already warned about (the
    once-per-run dedup in :func:`restore`). Test hook."""
    _NARROWED_WARNED.clear()


def restore(path: str, like):
    """Restore into the structure of ``like`` (keys must match).

    Leaves come back as tensors at their stored dtype, on the device of
    ``like``'s leaf (the CPU where that leaf is not a tensor). torch
    holds every dtype the JAX package writes, so unlike the reference's
    ``jnp`` leaves under x64=off nothing is narrowed in practice; should
    a leaf's dtype differ from the stored one, a ``UserWarning`` names
    the narrowed keys and points at :func:`restore_dict`, once per run
    per narrowed-key set (:func:`reset_narrowing_warnings` clears it).
    """
    payload = _read_payload(path)
    keys, like_leaves = _paths(like)
    stored = dict(zip(payload["keys"], payload["leaves"]))
    missing = [k for k in keys if k not in stored]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    leaves = [_record_to_leaf(stored[k], old)
              for k, old in zip(keys, like_leaves)]
    narrowed = [k for k, leaf in zip(keys, leaves)
                if _dtype_name(leaf) != stored[k]["dtype"]]
    if narrowed and frozenset(narrowed) not in _NARROWED_WARNED:
        _NARROWED_WARNED.add(frozenset(narrowed))
        warnings.warn(
            f"checkpoint.restore narrowed the stored dtype of "
            f"{len(narrowed)} leaves (e.g. {narrowed[0]!r}: "
            f"{stored[narrowed[0]]['dtype']} -> "
            f"{_dtype_name(leaves[keys.index(narrowed[0])])}); use "
            f"checkpoint.restore_dict for exact-dtype numpy restore",
            UserWarning, stacklevel=2)
    for k, new, old in zip(keys, leaves, like_leaves):
        if tuple(new.shape) != tuple(np.shape(old)):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(new.shape)} vs {np.shape(old)}")
    return _unflatten(like, iter(leaves))


def tree_to_arrays(tree, prefix: str = "") -> dict:
    """Flatten a tree to ``{"/"-joined path: numpy array}`` (a bfloat16
    leaf stays a CPU ``torch.bfloat16`` tensor).

    The flat form trainers use to export server state (params +
    optimizer moments) into ``TaskState.trainer_state`` for format-4
    lifecycle checkpoints; invert with :func:`tree_from_arrays`.
    """
    keys, leaves = _paths(tree)
    pre = prefix + "/" if prefix else ""
    out = {}
    for k, leaf in zip(keys, leaves):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            out[pre + k] = leaf.detach().cpu().clone()
        else:
            out[pre + k] = _to_numpy(leaf).copy()
    return out


def tree_from_arrays(like, arrays: dict, prefix: str = ""):
    """Rebuild a tree structured like ``like`` from a
    :func:`tree_to_arrays` mapping (missing keys raise KeyError). Leaves
    come back as tensors cast to the ``like`` leaf's dtype, on its
    device."""
    keys, like_leaves = _paths(like)
    pre = prefix + "/" if prefix else ""
    leaves = []
    for k, old in zip(keys, like_leaves):
        arr = arrays[pre + k]
        if tuple(arr.shape) != tuple(np.shape(old)):
            raise ValueError(f"shape mismatch at {k}: "
                             f"{tuple(arr.shape)} vs {np.shape(old)}")
        if isinstance(old, torch.Tensor):
            t = arr if isinstance(arr, torch.Tensor) \
                else torch.from_numpy(np.array(arr))
            t = t.to(device=old.device, dtype=old.dtype)
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.asarray(old).dtype))
        leaves.append(t)
    return _unflatten(like, iter(leaves))


class CheckpointManager:
    """step-numbered checkpoints with rotation."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.ckpt")

    def steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.ckpt", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, tree) -> str:
        p = self._step_path(step)
        save(p, tree)
        for old in self.steps()[:-self.keep]:
            os.remove(self._step_path(old))
        return p

    def restore_latest(self, like):
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return steps[-1], restore(self._step_path(steps[-1]), like)
