"""Multi-pod dry-run: the JAX package's ``launch/dryrun.py`` as a DTensor
trace on a fake process group.

For every (architecture x input shape) pair, run the step once on the
production mesh (16x16 single-pod and 2x16x16 multi-pod) as DTensors
whose local shards are meta tensors, count what each device would do,
and write a JSON artifact under ``artifacts/dryrun_torch/``.

The trace is abstract, as the reference's compile for host devices is:
nothing runs on any device and nothing is allocated. It is not a CPU
fallback. The process is rank 0 of a fake process group of the mesh's
size (:func:`repro_torch.launch.mesh.fake_device_mesh`), so DTensor
inserts the collectives a sharded run needs and they complete at once.
Parameters come from ``FakeTensorMode`` (shapes and dtypes only) and
are placed by the sharding rules (``repro_torch.sharding``), as are the
optimizer state, the batch and the cache (``launch.inputs``); the step
runs under ``implicit_replication()``, so the plain tensors the model
makes (RoPE tables, masks) count as replicated. The model takes its
plain path (``use_kernels=False``), as the reference lowers with
``use_pallas=False``.

**Cost.** :class:`LocalCost` sees every op on the local shards: per
device, it counts flops (the formulas of ``torch.utils.flop_counter``),
bytes (each op's tensor inputs plus outputs, views free: an unfused
count, larger than what fused kernels move), the collectives by their
local output bytes, and the live bytes of the local tensors the step
made (``temp_size_in_bytes`` is their peak). The eager trace runs every
layer, so the reference's probe correction of a scan body counted once
has nothing to correct: ``cost_corrected`` is null.

**Memory.** ``argument_size_in_bytes`` is the local shards of params,
optimizer state, batch and cache; ``output_size_in_bytes`` the local
outputs. ``alias_size_in_bytes`` is 0: the reference's donation (``--opt
>= 1``) has no counterpart in an eager trace (a decode step updates a
stacked cache in place all the same).

**The mesh.** On the multi-pod mesh, ``"pod"`` and ``"data"`` are
traced as one mesh dim of 32 (``mesh_dims`` in the artifact) wherever
every spec names them together or neither, as every spec but a
batch-1 cache's does: DTensor cannot view a dim split over two mesh
dims, and one dim over (pod, data) is laid out as that one dim is.

**Ops DTensor cannot place.** An op DTensor has no strategy for gets
one through ``register_sharding`` (``log_sigmoid_backward``, which is
pointwise). A few ops are run by hand (:data:`_HANDLERS`; the
artifact's ``handled_ops`` counts each with what was done):
``index_put_`` and ``index_put`` are written into each local shard,
rows added into a buffer (the MoE dispatch, an embedding's backward)
as partial sums left for the reader to reduce, and a write into a
sharded dim (the slot of a sequence-sharded KV cache) as the
flash-decoding layout's owner write; ``detach_``, ``flip`` and
``constant_pad_nd`` run on the local shard (a flipped or padded dim
split over the mesh replicated first); a view DTensor refuses as
needing a redistribution gets the dims it merges or splits replicated,
as few as let it run, the all-gather counted, and one the local
shard's strides refuse copies the shard first. Any other op DTensor
cannot run fails the trace: nothing is replicated behind the count's
back.

``--opt`` levels: 1 shards the cache's sequence over ``"model"``
(``seq_over_model``); 2 pads experts to the model axis and takes 8
microbatches; 3 shards expert ff dims over the data axes on serve
shapes (``expert_2d``); 4 changes nothing (the port's stack is already
a Python loop).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k [--mesh 4,2]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import math
import os
import time
import traceback
import warnings
import weakref

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as R
from repro_torch.launch.inputs import (SHAPES, input_specs, make_prefill_step,
                                       make_serve_step, make_train_step,
                                       model_flops_for, shape_config,
                                       shape_dims)
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.launch.trace_compat import (TorchDispatchMode,
                                             fake_tensor_mode, is_fake,
                                             storage_of)
from repro_torch.models import transformer as T
from repro_torch.optim import tree_map
from repro_torch.sharding import (batch_shardings, cache_shardings,
                                  opt_state_shardings, params_shardings,
                                  placements)
from repro_torch.sharding.specs import mesh_axis_size

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# long_500k applicability notes: who runs it and why.
LONG_OK = {a: "window-8192 variant" for a in ARCH_IDS}
LONG_OK["xlstm-125m"] = "native recurrent state"
LONG_OK["hymba-1.5b"] = "native: SSM state + window-1024 attention"
LONG_OK["whisper-large-v3"] = ("window-8192 variant; out-of-domain for "
                               "whisper's decoder, mechanical support only")

# ---------------------------------------------------------------------------
# Per-device cost of the local ops
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


class LocalCost(TorchDispatchMode):
    """Counts what the local ops of a DTensor trace do on one device.

    DTensor ops are passed on (``NotImplemented``) and DTensor runs them
    as ops on the local shards, which come back here: those are counted.
    So are the c10d functional collectives DTensor inserts, by their
    local output bytes. Ops on fake tensors (DTensor's own shape
    propagation) are not the device's work and are not counted.

    An op DTensor cannot run raises: nothing is replicated behind its
    back. The ops of :data:`_HANDLERS` are run by hand, each counted in
    :attr:`handled` with what was done."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self.handled = collections.Counter()  # op: what was done
        self._storages = weakref.WeakSet()    # counted or left out
        self._inside = False

    def exclude(self, tree) -> None:
        """Leave the storages of ``tree``'s tensors (a DTensor's: its
        local shard's) out of the live bytes: the step's arguments,
        counted apart."""
        for t in _tensors(tree):
            self._storages.add(storage_of(_local(t)))

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        s = storage_of(t)
        if s in self._storages:
            return
        self._storages.add(s)
        n = s.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._inside:
                return NotImplemented       # DTensor's own dispatch
            handler = _HANDLERS.get(func)
            if handler is not None:
                return handler(self, func, *args, **kwargs)
            return self._run(lambda: func(*args, **kwargs))
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(is_fake(t) for t in ins + outs):
            return out
        name = func._schema.name.split("::")[-1]
        if func.namespace.startswith("_c10d_functional"):
            self.collectives.append((name, sum(_nbytes(o) for o in outs)))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        in_storages = {id(storage_of(a)) for a in ins}
        fresh = [o for o in outs if id(storage_of(o)) not in in_storages]
        if fresh and name not in _FREE_OPS:
            self.bytes += sum(_nbytes(a) for a in ins) \
                + sum(_nbytes(o) for o in fresh)
        for o in outs:
            self._track(o)
        return out

    def _run(self, thunk):
        """``thunk()`` with this mode active for the local ops DTensor
        runs, and DTensor dispatching its own ops."""
        self._inside = True
        try:
            with self:
                return thunk()
        finally:
            self._inside = False

    def _index_put_(self, func, dst, indices, values, accumulate=False):
        """``dst[indices] = values`` (or ``+=``) in place into a DTensor,
        written into each local shard; the redistributions it takes are
        counted, and so is the local write.

        Rows added into a buffer (:meth:`_rows_added`) are added where
        they are and reduced into ``dst``. Otherwise ``values`` is placed
        like ``dst`` on the dims not indexed and replicated on the
        indexed ones, and the indices replicated. Where ``dst`` shards an
        indexed dim (a sequence-sharded KV cache's slot) this is the
        owner's write of the flash-decoding layout, counted on every
        shard: DTensor has no strategy that keeps ``dst`` in place
        there, and torch 2.11's has none for ``index_put_`` at all."""
        from torch.distributed.tensor import Replicate

        mesh = dst.device_mesh
        replicated = [Replicate()] * mesh.ndim
        with self:
            values = _as_dtensor(values, mesh)
            if accumulate and _are_rows(dst, indices, values):
                self.handled[f"{func}: rows added shard by shard"] += 1
                part = self._rows_added(dst, indices, values)
                dst.to_local().add_(
                    part.redistribute(mesh, dst.placements).to_local())
                return dst
            self.handled[f"{func}: written shard by shard"] += 1
            indexed = {d for d, ix in enumerate(indices) if ix is not None}
            keep = [Replicate() if p.is_shard() and p.dim in indexed else p
                    for p in dst.placements]
            # broadcast from the right, as indexing does
            values = values.reshape((1,) * (dst.ndim - values.ndim)
                                    + tuple(values.shape))
            values = values.redistribute(mesh, keep)
            local = [None if ix is None else _as_dtensor(ix, mesh)
                     .redistribute(mesh, replicated).to_local()
                     for ix in indices]
            torch.ops.aten.index_put_.default(
                dst.to_local(), local, values.to_local(), accumulate)
        return dst

    def _index_put(self, func, dst, indices, values, accumulate=False):
        """``index_put``, out of place (the backward of an index: rows
        added into zeros). Torch 2.11's strategy for it fails on a
        partial ``values``; rows added are :meth:`_rows_added`, and
        anything else is :meth:`_index_put_` on a copy."""
        with self:
            values = _as_dtensor(values, dst.device_mesh)
            if accumulate and _are_rows(dst, indices, values):
                self.handled[f"{func}: rows added shard by shard"] += 1
                return dst + self._rows_added(dst, indices, values)
            out = dst.clone()
        return self._index_put_(torch.ops.aten.index_put_.default, out,
                                indices, values, accumulate)

    def _rows_added(self, dst, indices, values):
        """The rows of ``values`` added at ``indices`` into zeros shaped
        like ``dst``, as a DTensor placed like ``dst`` except that it is
        a partial sum over each mesh dim that splits the rows, or holds
        them partial, and not ``dst``: each shard adds the rows it holds,
        and the reduction is left to whoever reads the sum, as a
        partitioner does a scatter-add into a replicated operand (the
        MoE dispatch, an embedding's backward)."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)

        mesh, k, r = dst.device_mesh, len(indices), indices[0].ndim
        if any(p.is_partial() or p.is_shard() and p.dim < k
               for p in dst.placements):
            raise NotImplementedError(f"rows added into a buffer placed "
                                      f"{dst.placements}")
        rows, per_row, out = [], [], []
        for p, v in zip(dst.placements, values.placements):
            if p.is_shard():                     # a row's dim split
                rows.append(Replicate())
                per_row.append(Shard(p.dim - k + r))
                out.append(p)
            elif v.is_shard() and v.dim < r or v.is_partial():
                rows.append(v if v.is_shard() else Replicate())
                per_row.append(v)
                out.append(Partial())
            else:
                rows.append(Replicate())
                per_row.append(Replicate())
                out.append(p)
        local = torch.zeros_like(dst.to_local())
        torch.ops.aten.index_put_.default(
            local, [_as_dtensor(ix, mesh).redistribute(mesh, rows).to_local()
                    for ix in indices],
            values.redistribute(mesh, per_row).to_local(), True)
        return DTensor.from_local(local, mesh, out, run_check=False,
                                  shape=dst.shape, stride=dst.stride())

    def _detach_(self, func, dst):
        """``detach_`` of a DTensor (torch 2.11 has no strategy for it):
        its local shard's, which moves no data."""
        self.handled[f"{func}: on the local shard"] += 1
        with self:
            func(dst.to_local())
        return dst

    def _pad(self, func, x, pad, value=0.0):
        """``constant_pad_nd`` of a DTensor (torch 2.11's strategy for it
        fails on a tensor split over two mesh dims): :meth:`_on_shards`,
        the padded dims kept whole, and a partial sum too where the pad
        value is not 0."""
        padded = {x.ndim - 1 - i for i in range(len(pad) // 2)
                  if pad[2 * i] or pad[2 * i + 1]}
        shape = list(x.shape)
        for d in padded:
            i = x.ndim - 1 - d
            shape[d] += pad[2 * i] + pad[2 * i + 1]
        return self._on_shards(func, x, padded, shape, value != 0, pad,
                               value)

    def _flip(self, func, x, dims):
        """``flip`` of a DTensor (torch 2.11 has no strategy for it):
        :meth:`_on_shards`, the flipped dims kept whole."""
        return self._on_shards(func, x, {d % x.ndim for d in dims},
                               list(x.shape), False, dims)

    def _on_shards(self, func, x, whole, shape, no_partial, *args):
        """``func(local, *args)`` on each local shard of ``x``, the
        result placed as ``x`` is with global ``shape``; a mesh dim that
        splits one of the dims ``whole`` (or, with ``no_partial``, holds
        a partial sum) is replicated first, counted and in
        :attr:`handled`."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = x.device_mesh
        over = [m for m, p in enumerate(x.placements)
                if p.is_shard() and p.dim in whole
                or p.is_partial() and no_partial]
        with self:
            if over:
                names = ",".join(mesh.mesh_dim_names[m] for m in over)
                self.handled[f"{func}: replicated over {names}"] += 1
                x = x.redistribute(mesh, [Replicate() if m in over else p
                                          for m, p in enumerate(x.placements)])
            else:
                self.handled[f"{func}: on each local shard"] += 1
            return DTensor.from_local(
                func(x.to_local(), *args), mesh, x.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())

    def _view(self, func, x, size):
        """A view of a DTensor. Torch 2.11 refuses some views DTensor
        cannot do without a redistribution (a sharded dim merged into
        the dim before it, or split, or unevenly sharded). The placement
        is then the first that lets the view run, each tried in a count
        of its own that is thrown away: the shards on the dims the view
        merges or splits replicated over one mesh dim, then two, a dim
        that leads its group (a batch dim) kept split the longest. The
        redistribution to it is counted and the op in
        :attr:`handled`. Where the local shard's strides refuse a view
        the global tensor allows, the shard is copied first, as a
        reshape would. Any other failure raises."""
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        touched, firsts = _view_touched(tuple(x.shape), size, x.numel())
        over = [m for m, p in enumerate(x.placements)
                if p.is_shard() and p.dim in touched]
        # fewest mesh dims first, then those that split a group's first
        # dim last (a batch dim stays split), then the minor ones first
        subsets = sorted(
            (c for r in range(1, len(over) + 1)
             for c in itertools.combinations(over, r)),
            key=lambda c: (len(c), sum(x.placements[m].dim in firsts
                                       for m in c), [-m for m in c]))
        plans = [list(x.placements)] + [
            [Replicate() if m in c else p for m, p in enumerate(x.placements)]
            for c in subsets]
        for pls in plans:
            try:        # counted apart, and the count thrown away
                scratch = LocalCost()
                with scratch:
                    probe = x.redistribute(mesh, pls)
                scratch._run(lambda: func(probe, size))
                break
            except RuntimeError as e:
                if _STRIDED_VIEW in str(e):
                    break       # placed well; the shard is copied below
                if pls == plans[-1]:
                    raise
        if pls != plans[0]:
            over = ",".join(mesh.mesh_dim_names[m] for m, (p, q) in
                            enumerate(zip(x.placements, pls)) if p != q)
            self.handled[f"{func}: replicated over {over}"] += 1
            with self:
                x = x.redistribute(mesh, pls)
        mark = (len(self.collectives), self.flops, self.bytes)
        try:
            return self._run(lambda: func(x, size))
        except RuntimeError as e:
            if _STRIDED_VIEW not in str(e) or mark != (
                    len(self.collectives), self.flops, self.bytes):
                raise
        # the global view is valid, the local shard's strides refuse it:
        # a copy, as a reshape would make
        self.handled[f"{func}: local shard copied"] += 1
        with self:
            x = x.clone(memory_format=torch.contiguous_format)
        return self._run(lambda: func(x, size))


def _view_touched(shape: tuple, size, numel: int) -> tuple:
    """The dims of ``shape`` a view to ``size`` merges or splits, and
    the first of each such group: dims are grouped, in order, until the
    products of their sizes on both sides match."""
    size = list(size)
    if -1 in size:
        rest = math.prod(d for d in size if d != -1)
        size[size.index(-1)] = numel // rest if rest else 0
    touched, firsts, i, j = set(), set(), 0, 0
    while i < len(shape) or j < len(size):
        gi, gj, pi, pj = [], [], 1, 1
        if i < len(shape):
            gi.append(i)
            pi *= shape[i]
            i += 1
        if j < len(size):
            gj.append(j)
            pj *= size[j]
            j += 1
        while pi != pj and (i < len(shape) or j < len(size)):
            if pi < pj and i < len(shape) or j == len(size):
                gi.append(i)
                pi *= shape[i]
                i += 1
            else:
                gj.append(j)
                pj *= size[j]
                j += 1
        if len(gi) != 1 or len(gj) != 1:
            touched.update(gi)
            if gi:
                firsts.add(gi[0])
    return touched, firsts




_STRIDED_VIEW = "view size is not compatible with input tensor's size"


def _as_dtensor(t, mesh):
    """``t``, or a plain tensor as a DTensor replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _are_rows(dst, indices, values) -> bool:
    """Whether ``dst[indices] += values`` adds rows: an index on each of
    ``dst``'s leading dims, all of one shape, and ``values`` that shape
    followed by ``dst``'s other dims."""
    if any(ix is None for ix in indices):
        return False
    shape = tuple(indices[0].shape)
    return all(tuple(ix.shape) == shape for ix in indices) and \
        tuple(values.shape) == shape + tuple(dst.shape[len(indices):])


# Ops run by hand (each ``handler(cost, func, *args, **kwargs)``); every
# other op goes through DTensor's strategies or raises.
_HANDLERS = {
    torch.ops.aten.index_put_.default: LocalCost._index_put_,
    torch.ops.aten.index_put.default: LocalCost._index_put,
    torch.ops.aten.detach_.default: LocalCost._detach_,
    torch.ops.aten.constant_pad_nd.default: LocalCost._pad,
    torch.ops.aten.flip.default: LocalCost._flip,
    torch.ops.aten.view.default: LocalCost._view,
    torch.ops.aten._unsafe_view.default: LocalCost._view,
}

_REGISTERED = []


def _register_strategies() -> None:
    """Register, once a process, the sharding strategies DTensor lacks
    for ops the models run, through the public ``register_sharding``:
    ``log_sigmoid_backward`` (xLSTM's gates; torch 2.13 has none) is
    pointwise, so any dim may be split, its three tensors alike."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def log_sigmoid_backward(grad_output, x, buffer):
        return [([Replicate()], [Replicate()] * 3)] + [
            ([Shard(d)], [Shard(d)] * 3) for d in range(x.ndim)]
    _REGISTERED.append(log_sigmoid_backward)


# ---------------------------------------------------------------------------
# Building the step's arguments as DTensors
# ---------------------------------------------------------------------------

def fake_params(cfg):
    """The model's params as fake tensors: shapes and dtypes, no data."""
    with fake_tensor_mode():
        return T.init_params(cfg, torch.Generator())


def to_dtensor(template, spec, device_mesh):
    """A DTensor of ``template``'s global shape and dtype, placed by
    ``spec`` on ``device_mesh``, over a meta shard."""
    from torch.distributed.tensor import DTensor, Shard

    shape = tuple(template.shape)
    pls = placements(spec, device_mesh)
    local = list(shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n = device_mesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {shape} does not split "
                                 f"{n} ways")
            local[pl.dim] //= n
    shard = torch.empty(local, dtype=template.dtype, device="meta")
    return DTensor.from_local(
        shard, device_mesh, pls, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, dtype=template.dtype,
                           device="meta").stride())


def _meta_like(t, dtype):
    return torch.empty(t.shape, dtype=dtype, device="meta")


def build_lowerable(arch: str, shape: str, mesh, opt_level: int = 0):
    """``(step fn, args, specs, cfg)`` for ``arch``'s full config at
    ``shape`` (:func:`_build_from_cfg`). The eager trace runs every
    layer, so the reference's unrolled variant and its probe correction
    (``probe_corrected_cost``) have no counterpart here."""
    return _build_from_cfg(shape_config(get_config(arch), shape), shape,
                           mesh, opt_level=opt_level)


def _build_from_cfg(cfg, shape, mesh, opt_level: int = 0):
    """``(step fn, args, specs, cfg)`` for ``cfg`` at ``shape`` (a name
    in ``SHAPES`` or a ``(seq_len, batch, kind)`` tuple): the args as
    templates (fake params, meta inputs, the decode position as a Python
    int) and their specs on ``mesh`` by the sharding rules."""
    S, B, kind = shape_dims(shape)
    if opt_level >= 2 and cfg.is_moe:
        # pad experts up to a multiple of the model axis so expert-
        # parallel sharding applies (function-preserving)
        tp = mesh_axis_size(mesh, "model")
        if cfg.num_experts % tp:
            cfg = dataclasses.replace(
                cfg, pad_experts_to=-(-cfg.num_experts // tp) * tp)
    params = fake_params(cfg)
    expert_2d = opt_level >= 3 and kind != "train"
    p_specs = params_shardings(params, mesh, expert_2d=expert_2d)
    specs = input_specs(cfg, shape)
    batch = specs["batch"]
    b_specs = batch_shardings(batch, mesh)
    if kind == "train":
        micro = 8 if opt_level >= 2 else 1   # grad accumulation
        step, _ = make_train_step(cfg, microbatches=micro)
        moments = tree_map(lambda t: _meta_like(t, torch.float32), params)
        opt_state = {"count": _meta_like(torch.empty(()), torch.int32),
                     "m": moments, "v": moments}
        return (step, (params, opt_state, batch),
                (p_specs, opt_state_shardings(params, mesh), b_specs), cfg)
    if kind == "prefill":
        return make_prefill_step(cfg), (params, batch), (p_specs, b_specs), \
            cfg
    cache = specs["cache"]
    c_specs = cache_shardings(cache, mesh, batch=B,
                              seq_over_model=opt_level >= 1)
    # the decode position: the cache's last slot (a Python int, as the
    # port's decode_step reads it)
    batch, b_specs = dict(batch, index=S - 1), dict(b_specs, index=None)
    return (make_serve_step(cfg), (params, batch, cache),
            (p_specs, b_specs, c_specs), cfg)


def _merges_data_axes(args, specs) -> bool:
    """Whether every spec of a tensor names ``"pod"`` and ``"data"``
    together or neither, so the trace may merge them into one mesh dim
    (:func:`repro_torch.launch.mesh.fake_device_mesh`)."""
    together = []

    def one(t, spec):
        if isinstance(t, torch.Tensor):
            for entry in spec:
                axes = set(entry if isinstance(entry, tuple) else (entry,))
                together.append(len(axes & {"pod", "data"}) != 1)
    tree_map(one, args, specs)
    return all(together)


def trace_step(cfg, shape, mesh, opt_level: int = 0) -> dict:
    """Run ``cfg``'s step for ``shape`` once as a DTensor trace on a
    fake process group of ``mesh`` (:func:`trace`)."""
    return trace(_build_from_cfg(cfg, shape, mesh, opt_level=opt_level),
                 mesh)


def trace(built, mesh) -> dict:
    """Run the step :func:`_build_from_cfg` built once as a DTensor trace
    on a fake process group of ``mesh``, ``"pod"`` and ``"data"`` one
    mesh dim where the specs allow it; returns the per-device cost,
    memory and collectives, and the mesh dims traced."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args, specs, cfg = built
    merge = _merges_data_axes(args, specs)
    _register_strategies()
    with fake_device_mesh(mesh, merge_data_axes=merge) as device_mesh, \
            warnings.catch_warnings():
        # DTensor's note on each one-element index it replicates
        warnings.filterwarnings("ignore", message="Found a non-scalar")
        placed = tree_map(lambda t, spec: to_dtensor(t, spec, device_mesh)
                          if isinstance(t, torch.Tensor) else t, args, specs)
        del args
        arg_bytes = sum(_nbytes(_local(t)) for t in _tensors(placed))
        cost = LocalCost()
        cost.exclude(placed)
        # no autograd graph but the train step's own (it enables grad)
        with cost, implicit_replication(), torch.no_grad():
            out = fn(*placed)
        out_bytes = sum(_nbytes(_local(t)) for t in _tensors(out))
        mesh_dims = dict(zip(device_mesh.mesh_dim_names,
                             device_mesh.mesh.shape))
        del out, placed
    coll = R.collective_bytes(cost.collectives)
    return {"cfg": cfg, "flops": float(cost.flops),
            "bytes_accessed": float(cost.bytes), "coll": coll,
            "handled_ops": dict(cost.handled),
            "mesh_dims": {k: int(v) for k, v in mesh_dims.items()},
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": out_bytes,
                       "temp_size_in_bytes": cost.peak,
                       "alias_size_in_bytes": 0}}


def run_one(arch: str, shape: str, multi_pod: bool = False,
            out_dir: str | None = None, verbose: bool = True,
            opt_level: int = 0, mesh_shape: tuple | None = None) -> dict:
    """Trace one (arch, shape) and record it as the reference does:
    ``ok`` with the memory, cost, collectives and roofline, or the
    error."""
    mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape)
    chips = mesh.devices.size
    mesh_name = "x".join(map(str, mesh.devices.shape))
    if opt_level:
        mesh_name += f"-opt{opt_level}"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
           "ok": False}
    t0 = time.time()
    try:
        traced = trace(build_lowerable(arch, shape, mesh,
                                       opt_level=opt_level), mesh)
        mf = model_flops_for(traced["cfg"], shape)
        cost = {"flops": traced["flops"],
                "bytes accessed": traced["bytes_accessed"]}
        terms = R.derive_terms(cost, traced["coll"], chips, mf)
        rec.update(
            ok=True, trace_s=round(time.time() - t0, 2),
            memory=traced["memory"],
            cost_raw={"flops": traced["flops"],
                      "bytes_accessed": traced["bytes_accessed"]},
            cost_corrected=None,
            collectives=traced["coll"], roofline=terms.as_dict(),
            mesh_dims=traced["mesh_dims"],
            handled_ops=traced["handled_ops"],
            note=LONG_OK.get(arch, "") if shape == "long_500k" else "")
        if verbose:
            mem = traced["memory"]
            bpd = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            print(f"[OK] {arch:24s} {shape:12s} {mesh_name:8s} "
                  f"trace={rec['trace_s']:6.1f}s bytes/dev={bpd/2**30:7.2f}GiB "
                  f"flops/dev={terms.flops:.3e} coll/dev={terms.coll_bytes:.3e} "
                  f"bottleneck={terms.bottleneck}", flush=True)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} {shape} {mesh_name}: {rec['error']}",
                  flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="per-pod mesh shape d,m (default 16,16)")
    ap.add_argument("--opt", type=int, default=0,
                    help="optimization level (1: sequence-sharded cache)")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("need --all or (--arch and --shape)")
    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) \
        if args.mesh else None

    results = [run_one(a, s, multi_pod=args.multi_pod, out_dir=args.out,
                       opt_level=args.opt, mesh_shape=mesh_shape)
               for a, s in combos]
    ok = sum(r["ok"] for r in results)
    print(f"\n{ok}/{len(results)} combos traced OK")
    raise SystemExit(0 if ok == len(results) else 1)


if __name__ == "__main__":
    main()
