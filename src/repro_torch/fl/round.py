"""Federated rounds in PyTorch, at simulation scale.

- ``make_fl_round``: one FedAvg round per call on client batches that
  the caller assembled (the host-loop data plane,
  ``fl.simulation.FLClassificationSim``): every scheduled client runs E
  local SGD steps from its own copy of the parameters (``torch.func``:
  ``grad`` inside ``vmap`` over the client axis), then the server
  aggregates the weighted deltas and applies w_{t+1} = w_t − η Δ_t
  (paper §III). The aggregate is ``tree_weighted_sum``, one weighted
  column sum per parameter leaf (the ``fedavg_agg`` kernel with
  ``use_agg_kernel=True``), and the quality cosines a second pass over
  the deltas; ``fused_quality=True`` takes the fused pass below instead.

- ``make_fl_rounds_scan``: the device-resident round data plane, S
  rounds per call over precomputed schedule tensors (padded
  subsets/weights from stage 2). Each round draws its client batches and
  dropout mask on the device (fl.device_data), trains as above, and by
  default applies the fused aggregation + quality pass
  (kernels.ops.fedavg_agg_quality: one read of the stacked deltas yields
  Δ_t and every q_t cosine), then the server step, or a server
  optimizer's step (FedAdam/FedYogi). With a compression spec the server
  aggregates from the encoded deltas (fl.compression). A schedule may
  carry the lifecycle's fault-mode arrival masks. Nothing in here forces
  a result to the host, so on the card a chunk is enqueued and the
  caller decides when to block.

- ``make_fl_rounds_scan_sharded``: the same chunk function with the
  round's client axis split over a mesh's data shards
  (launch.mesh): each shard trains its K/n clients on its own device,
  and their weighted sums are added on the mesh's first device, the
  counterpart of the reference's ``psum``.

- ``make_fedsgd_step``: the datacenter-scale one-local-step equivalent,
  a data-parallel train step whose per-example weights fold the FedAvg
  p_k into the loss (launch.train drives it).

The round functions run their convolutions inside
:func:`repro_torch.device.conv_numerics`
(full f32, deterministic cuDNN algorithms), so rounds repeat bit for bit
on the card and the caller's cuDNN settings are left as they were.

Their parameters are flat ``dict[str, Tensor]`` (models.cnn). Leaves are
ordered by sorted name, which is JAX's pytree order for the reference's
nested dicts (``b`` before ``w``), so the flattened (K, P) matrix has
the reference's column order.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.device import conv_numerics
from repro_torch.fl import device_data
from repro_torch.fl.compression import (CompressionSpec, aggregate_compressed,
                                        bytes_per_client)
from repro_torch.kernels import ops as kops
from repro_torch.optim import apply_updates, tree_leaves, tree_map
from repro_torch.sharding import specs as sharding_specs


def flatten_stacked(stacked: dict[str, torch.Tensor]):
    """Stacked params (leaves (K, ...)) -> ((K, P) tensor, unflatten).

    ``unflatten`` restores a (P,) vector to the original names, shapes
    and dtypes."""
    names = sorted(stacked)
    K = stacked[names[0]].shape[0]
    ctype = functools.reduce(torch.promote_types,
                             [stacked[n].dtype for n in names])
    flats = [stacked[n].reshape(K, -1).to(ctype) for n in names]
    sizes = [f.shape[1] for f in flats]
    shapes = [stacked[n].shape[1:] for n in names]
    dtypes = [stacked[n].dtype for n in names]

    def unflatten(vec):
        parts = torch.split(vec, sizes)
        return {n: p.reshape(s).to(d)
                for n, p, s, d in zip(names, parts, shapes, dtypes)}

    return torch.cat(flats, dim=1), unflatten


def tree_sub(a: dict, b: dict) -> dict:
    return {n: a[n] - b[n] for n in a}


def tree_weighted_sum(trees_stacked: dict, weights: torch.Tensor,
                      use_kernel: bool = False, kernels=kops) -> dict:
    """Σ_k w_k · leaf[k] for every leaf with leading client axis K.

    The plain branch casts the weights to the leaf's dtype and sums in
    f32, as the reference's ``dot_general`` with an f32 result does; the
    kernel branch is ``kernels.fedavg_agg_tree`` (``fedavg_agg`` over all
    the leaves in one launch), whose weights are f32. The two agree for f32 leaves; for bf16
    leaves the rounded weights differ (ROADMAP.md, known differences).
    """
    if use_kernel:
        return kernels.fedavg_agg_tree(trees_stacked, weights)
    out = {}
    for name, leaf in trees_stacked.items():
        flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
        acc = weights.to(leaf.dtype).to(torch.float32) @ flat
        out[name] = acc.reshape(leaf.shape[1:]).to(leaf.dtype)
    return out


def _tree_dot(a: dict, b: dict) -> torch.Tensor:
    """Σ over leaves (sorted names, JAX's leaf order) of ⟨a, b⟩ in f32,
    each leaf's products summed by ``torch.sum``'s pairwise reduction
    (a CPU BLAS dot sums a million f32 products in a few running
    partials: 1e-4 off in a CIFAR_CNN cosine)."""
    return sum(torch.sum(a[n].to(torch.float32) * b[n].to(torch.float32))
               for n in sorted(a))


def _quality_cosines(deltas: dict, agg: dict) -> torch.Tensor:
    """Per-client q_t = cos(Δ_t^(k), Δ_t) against a given aggregate (the
    two-pass quality path), with the aggregate's norm hoisted out of the
    loop over clients."""
    nb = torch.sqrt(_tree_dot(agg, agg))

    def cos_one(dk):
        na = torch.sqrt(_tree_dot(dk, dk))
        return _tree_dot(dk, agg) / torch.clamp_min(na * nb, 1e-12)

    return torch.func.vmap(cos_one)(deltas)


def _make_client_update(loss_fn: Callable, local_lr: float):
    """Local SGD for one client, one step per slice of the batches'
    leading axis E; returns (delta, mean_loss)."""
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def client_update(params, batches):
        p = params
        losses = []
        for e in range(next(iter(batches.values())).shape[0]):
            grads, (loss, _) = grad_fn(p, {k: v[e] for k, v in batches.items()})
            p = {n: p[n] - local_lr * grads[n] for n in p}
            losses.append(loss)
        return tree_sub(params, p), torch.stack(losses).mean()

    return client_update


def aggregate_and_quality(deltas, w, spec: CompressionSpec, kernels=kops,
                          use_agg_kernel: bool = False,
                          fused_quality: bool = True):
    """Weighted aggregate Δ_t + per-client q_t = cos(Δ_t^(k), Δ_t).
    Returns ``(agg, q, per-client wire bytes or None)``.

    - ``spec`` active: from the encoded deltas' payloads (q on the
      decoded deltas);
    - ``fused_quality``: one fused pass over the flattened deltas
      (``kernels.fedavg_agg_quality``);
    - else the two-pass path: ``tree_weighted_sum`` (the ``fedavg_agg``
      kernel over all leaves with ``use_agg_kernel``), then the cosines.
    """
    if not spec.active and not fused_quality:
        agg = tree_weighted_sum(deltas, w, use_agg_kernel, kernels)
        return agg, _quality_cosines(deltas, agg), None
    flat, unflatten = flatten_stacked(deltas)
    if spec.active:
        agg_flat, dots, sq, asq = aggregate_compressed(flat, w, spec,
                                                       kernels=kernels)
        per_client = bytes_per_client(spec, flat.shape[1],
                                      flat.element_size())
    else:
        agg_flat, dots, sq, asq = kernels.fedavg_agg_quality(flat, w)
        per_client = None
    q = dots / torch.clamp_min(torch.sqrt(sq) * torch.sqrt(asq), 1e-12)
    return unflatten(agg_flat), q, per_client


def make_fl_round(loss_fn: Callable, local_lr: float = 0.05,
                  local_steps: int = 1, server_lr: float = 1.0,
                  use_agg_kernel: bool = False, fused_quality: bool = False,
                  kernels=kops):
    """One FedAvg round per call.

    ``loss_fn(params, batch) -> (loss, metrics)``. Returns
    ``round_fn(params, client_batches, weights, mask) -> (params, info)``
    where every leaf of ``client_batches`` is (K, E, ...) (E local steps
    each; ``local_steps`` names E for the caller, the batches decide it),
    ``weights`` (K,) are the FedAvg p_k and ``mask`` (K,) zeroes the
    clients that dropped (b_t = 0). ``info`` holds ``client_losses``
    (K,), ``q_values`` (K,) (each client's cosine to Δ_t, 0 where masked)
    and ``mean_loss`` ().

    ``use_agg_kernel`` aggregates through the ``fedavg_agg`` kernel
    (one launch over all leaves; the plain weighted sum otherwise);
    ``fused_quality`` takes the fused aggregation + quality pass.
    ``kernels`` is where the ops come from (``kernels.ops.PLAIN`` runs
    the plain versions on the card).
    """
    spec = CompressionSpec.parse(None)
    client_update = torch.func.vmap(_make_client_update(loss_fn, local_lr),
                                    in_dims=(None, 0))

    @torch.no_grad()
    def round_fn(params, client_batches, weights, mask):
        with conv_numerics():
            deltas, losses = client_update(params, client_batches)
        w = weights * mask
        w = w / torch.clamp_min(w.sum(), 1e-9)
        agg, q, _ = aggregate_and_quality(deltas, w, spec, kernels,
                                          use_agg_kernel, fused_quality)
        new_params = {n: (p - server_lr * agg[n]).to(p.dtype)
                      for n, p in params.items()}
        return new_params, {"client_losses": losses, "q_values": q * mask,
                            "mean_loss": (losses * w).sum()}

    return round_fn


def make_fl_rounds_scan(loss_fn: Callable, local_lr: float = 0.05,
                        local_steps: int = 1, batch_size: int = 16,
                        server_lr: float = 1.0, dropout_rate: float = 0.0,
                        fused_quality: bool = True,
                        use_agg_kernel: bool = False,
                        compression=None, server_opt=None, kernels=kops,
                        gather_fn: Callable | None = None):
    """Chunked multi-round function: S rounds per call.

    Returns ``chunk_fn(carry, data, schedule, base_key)`` where

    - ``carry`` is the flat parameter dict, or ``(params, opt_state)``
      with a ``server_opt`` (neither is modified; new ones come back),
    - ``data`` is a :class:`repro_torch.fl.device_data.DeviceDataset`,
    - ``schedule`` is a dict of stacked per-round tensors from stage 2:
      ``rows (S, K)`` int64 positions into the dataset pools, ``weights
      (S, K)`` f32 FedAvg p_k, ``active (S, K)`` f32 padding mask
      (subsets sized n±δ are padded to a static K with actives first),
      ``round_ids (S,)`` int64 global round indices, and, only under a
      lifecycle fault plan, ``arrival (S, K)`` f32 marking the clients
      that reported by the round's collect close (the others are masked
      out of the aggregate). Without ``arrival`` the rounds are the
      no-fault ones, bit for bit.
    - ``base_key`` is a :mod:`repro_torch.random` key that seeds batch
      sampling + dropout via per-(round, slot) key folds.

    Outputs stack across the chunk: ``(carry', {"masks": (S,K),
    "q_values": (S,K), "client_losses": (S,K), "mean_loss": (S,)})``.

    - ``fused_quality`` (default): the fused aggregation + quality pass;
      ``False`` takes the two-pass path, through the ``fedavg_agg``
      kernel over all leaves when ``use_agg_kernel`` (see
      :func:`aggregate_and_quality`).
    - ``compression``: a spec string or
      :class:`repro_torch.fl.compression.CompressionSpec`
      (``TaskRequest.compression``). When active, the server aggregates
      from the encoded deltas, q comes from the decoded ones, and the
      metrics gain ``"bytes" (S,)``: arrived clients × per-client wire
      bytes. ``None`` or ``"none"`` runs the uncompressed plane, with
      bit-identical results.
    - ``server_opt``: a :mod:`repro_torch.optim` Optimizer applied to the
      pseudo-gradient Δ_t (FedAdam/FedYogi); the carry is then
      ``(params, opt_state)`` and ``server_lr`` is ignored (fold it into
      the optimizer's lr). ``None`` keeps the plain SGD server step.
    - ``kernels``: where the aggregation and codec ops come from
      (:mod:`repro_torch.kernels.ops`); a caller may hand in
      ``kernels.ops.PLAIN`` to hold the kernels against their plain
      versions on one device.
    - ``gather_fn(data, rows, pos_u) -> batch dict``: batch assembly;
      defaults to the image gather (:func:`device_data.gather_batches`).
      The LM plane passes :func:`device_data.gather_lm_batches` with a
      :class:`~repro_torch.fl.device_data.DeviceLMDataset`.
    """
    spec = CompressionSpec.parse(compression)
    gather = device_data.gather_batches if gather_fn is None else gather_fn
    client_update = torch.func.vmap(_make_client_update(loss_fn, local_lr),
                                    in_dims=(None, 0))

    @torch.no_grad()
    def chunk_fn(carry, data, schedule, base_key):
        params, opt_state = (carry, None) if server_opt is None else carry
        S, K = schedule["rows"].shape
        arrival = schedule.get("arrival")
        mask_u, pos_u = device_data.sample_positions(
            base_key, schedule["round_ids"], K, local_steps, batch_size)
        infos = []
        for t in range(S):
            rows = schedule["rows"][t]
            # a scheduled client with an empty pool cannot return an
            # update: treat its slot as inactive (b_t = 0, weight 0)
            active = schedule["active"][t] * (data.sizes[rows] > 0)
            mask = device_data.dropout_mask(
                mask_u[t], active, dropout_rate,
                arrival=None if arrival is None else arrival[t])
            batch = gather(data, rows, pos_u[t])
            with conv_numerics():
                deltas, losses = client_update(params, batch)
            w = schedule["weights"][t] * mask
            w = w / torch.clamp_min(w.sum(), 1e-9)
            agg, q, per_client = aggregate_and_quality(
                deltas, w, spec, kernels, use_agg_kernel, fused_quality)
            if server_opt is None:
                params = {n: (p - server_lr * agg[n]).to(p.dtype)
                          for n, p in params.items()}
            else:
                # Δ_t is the server pseudo-gradient (FedOpt): the
                # optimizer's update replaces −server_lr·Δ_t
                upd, opt_state = server_opt.update(agg, opt_state, params)
                params = apply_updates(params, upd)
            info = {"masks": mask, "q_values": q * mask,
                    "client_losses": losses,
                    "mean_loss": (losses * w).sum()}
            if per_client is not None:
                info["bytes"] = mask.sum() * float(per_client)
            infos.append(info)
        carry = params if server_opt is None else (params, opt_state)
        return carry, {k: torch.stack([i[k] for i in infos])
                       for k in infos[0]}

    return chunk_fn


def shard_devices(mesh) -> list:
    """Each data shard's device, in the reference's shard order (row-major
    over the data axes): the shard's first device along the other axes,
    which in the reference hold replicas of the same computation."""
    dax = sharding_specs.data_axes(mesh)
    lead = [mesh.axis_names.index(a) for a in dax if a in mesh.axis_names]
    rest = [i for i in range(len(mesh.axis_names)) if i not in lead]
    devs = np.transpose(mesh.devices, lead + rest)
    n = sharding_specs.mesh_axis_size(mesh, dax)
    return list(devs.reshape(n, -1)[:, 0])


def _psum(values: list, home) -> torch.Tensor:
    """Σ over shards, added on ``home`` in shard order."""
    total = values[0].to(home)
    for v in values[1:]:
        total = total + v.to(home)
    return total


def _on_devices(tree: dict, devs) -> dict:
    """One copy of a flat tensor dict per distinct device (``Tensor.to``
    keeps the tensors that are there already)."""
    return {d: {n: v.to(d) for n, v in tree.items()}
            for d in dict.fromkeys(devs)}


def make_fl_rounds_scan_sharded(loss_fn: Callable, local_lr: float = 0.05,
                                local_steps: int = 1, batch_size: int = 16,
                                server_lr: float = 1.0,
                                gather_fn: Callable | None = None,
                                mesh=None):
    """Client-sharded variant of :func:`make_fl_rounds_scan`: each round's
    client axis K is split over the mesh's data axes, each shard trains
    its K/n clients (the same vmapped client update) on its device, and
    the weighted aggregate Δ_t, the weight sum and the weighted loss sum
    are added over the shards on the mesh's first device, in shard order
    (the reference's ``psum``); the totals go back to every shard.

    Same ``chunk_fn(params, data, schedule, base_key) -> (params, info)``
    contract and slot-keyed randomness as the unsharded scan: shard s
    draws its global slots through ``sample_positions(slot_offset=s*K/n)``,
    so batches, masks and deltas are those of the unsharded plane and
    only the f32 order of the sums differs. ``data`` is one staged
    dataset, or a dict holding one copy per distinct mesh device
    (``DeviceFLSim`` stages it so); ``params`` and every output live on
    the mesh's first device; masks, ``q_values`` and ``client_losses``
    come back in global slot order. Each shard's cosines q are taken
    against the global aggregate (the plain weighted sum and plain
    cosines, as the reference's sharded scan computes them). K must
    divide by the shard count (``ValueError`` otherwise; ``DeviceFLSim``
    pads K up).

    ``mesh=None`` builds :func:`repro_torch.launch.mesh.make_host_mesh`
    (every visible CUDA device on "data"). Scope, as the reference's:
    the uncompressed plain-SGD-server plane, no simulated dropout (its
    all-dropped fallback is global across K); fault-mode ``arrival``
    masks are split with the schedule.
    """
    from repro_torch.launch.mesh import make_host_mesh
    if mesh is None:
        mesh = make_host_mesh()
    devs = shard_devices(mesh)
    n_shard, home = len(devs), devs[0]
    gather = device_data.gather_batches if gather_fn is None else gather_fn
    client_update = torch.func.vmap(_make_client_update(loss_fn, local_lr),
                                    in_dims=(None, 0))

    @torch.no_grad()
    def chunk_fn(params, data, schedule, base_key):
        S, K = schedule["rows"].shape
        if K % n_shard:
            raise ValueError(
                f"client axis K={K} must be divisible by the data-axis "
                f"size {n_shard}; pad subsets (pad_subset_to) up")
        K_local = K // n_shard
        shards = []
        for s, dev in enumerate(devs):
            cols = slice(s * K_local, (s + 1) * K_local)
            sched = {k: (v if k == "round_ids" else v[:, cols]).to(dev)
                     for k, v in schedule.items()}
            staged = data[dev] if isinstance(data, dict) \
                else device_data.to_device(data, dev)
            mask_u, pos_u = device_data.sample_positions(
                base_key.to(dev), sched["round_ids"], K_local, local_steps,
                batch_size, slot_offset=s * K_local)
            shards.append((dev, sched, staged, mask_u, pos_u))
        infos = []
        for t in range(S):
            on = _on_devices(params, devs)
            local = []
            for dev, sched, staged, mask_u, pos_u in shards:
                rows = sched["rows"][t]
                active = sched["active"][t] * (staged.sizes[rows] > 0)
                mask = device_data.dropout_mask(
                    mask_u[t], active, 0.0,
                    arrival=sched["arrival"][t] if "arrival" in sched
                    else None)
                with conv_numerics():
                    deltas, losses = client_update(
                        on[dev], gather(staged, rows, pos_u[t]))
                local.append((mask, deltas, losses,
                              sched["weights"][t] * mask))
            wsum = _psum([w.sum() for *_, w in local], home)
            sums, loss_sums = [], []
            for (mask, deltas, losses, w), dev in zip(local, devs):
                w = w / torch.clamp_min(wsum.to(dev), 1e-9)
                sums.append(tree_weighted_sum(deltas, w))
                loss_sums.append((losses * w).sum())
            agg = {n: _psum([a[n] for a in sums], home) for n in sums[0]}
            agg_on = _on_devices(agg, devs)
            q = [(_quality_cosines(deltas, agg_on[dev]) * mask).to(home)
                 for (mask, deltas, _, _), dev in zip(local, devs)]
            params = {n: (p - server_lr * agg[n]).to(p.dtype)
                      for n, p in params.items()}
            infos.append({
                "masks": torch.cat([m.to(home) for m, *_ in local]),
                "q_values": torch.cat(q),
                "client_losses": torch.cat([l.to(home)
                                            for _, _, l, _ in local]),
                "mean_loss": _psum(loss_sums, home)})
        return params, {k: torch.stack([i[k] for i in infos])
                        for k in infos[0]}

    return chunk_fn


def make_fedsgd_step(loss_fn: Callable, optimizer, microbatches: int = 1,
                     unroll_microbatches: bool = False):
    """Datacenter-scale train step:
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``batch`` carries per-example ``weights`` = p_{k(example)} /
    examples_of_k, so the weighted loss's gradient is the paper's
    Δ_t = Σ_k p_k Δ_t^(k) for one local step. Gradients come from
    autograd over the whole tree (``loss_fn(params, batch) -> (loss,
    metrics)``), then ``optimizer.update`` and ``apply_updates``. The
    model should run its plain path (``use_kernels=False``): no kernel
    has a backward.

    ``microbatches > 1``: gradient accumulation. The batch splits along
    dim 0 into M microbatches taken in turn; each microbatch's gradients
    are cast to f32 and scaled by its share of the weights (1/M without
    weights), then summed, so the accumulated gradient matches the full
    batch's; ``metrics`` is then ``{"loss": Σ scaled losses}``.
    ``unroll_microbatches`` takes the same Python loop here (the
    reference's choice between ``lax.scan`` and an unrolled loop has no
    counterpart in eager PyTorch).
    """

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)}
        metrics = {k: m.detach() if torch.is_tensor(m) else m
                   for k, m in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda p: by_id[id(p)], live)

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            w_tot = torch.clamp_min(batch["weights"].sum(), 1e-9) \
                if "weights" in batch else None
            loss, grads = 0.0, None
            for i in range(microbatches):
                mb = {k: v[i] for k, v in split.items()}
                l, _, g = grads_of(params, mb)
                # each microbatch's loss is weight-normalised inside
                # loss_fn: rescale so the sum matches the full batch
                scale = mb["weights"].sum() / w_tot if w_tot is not None \
                    else 1.0 / microbatches
                g = tree_map(lambda x: x.to(torch.float32) * scale, g)
                loss = loss + l * scale
                grads = g if grads is None else tree_map(torch.add, grads, g)
            metrics = {"loss": loss}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, metrics

    return train_step
