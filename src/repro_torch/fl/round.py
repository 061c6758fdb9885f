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

Both run their convolutions inside :func:`repro_torch.device.conv_numerics`
(full f32, deterministic cuDNN algorithms), so rounds repeat bit for bit
on the card and the caller's cuDNN settings are left as they were.

Parameters are flat ``dict[str, Tensor]`` (models.cnn). Leaves are
ordered by sorted name, which is JAX's pytree order for the reference's
nested dicts (``b`` before ``w``), so the flattened (K, P) matrix has
the reference's column order.

Not ported yet (ROADMAP.md Queue 1): the client-sharded scan, the LM
batch gather and the FedSGD step.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.device import conv_numerics
from repro_torch.fl import device_data
from repro_torch.fl.compression import (CompressionSpec, aggregate_compressed,
                                        bytes_per_client)
from repro_torch.kernels import ops as kops
from repro_torch.optim import apply_updates


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
    kernel branch is ``kernels.fedavg_agg_tree`` (``fedavg_agg`` once per
    leaf), whose weights are f32. The two agree for f32 leaves; for bf16
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
    """Σ over leaves (sorted names, JAX's leaf order) of ⟨a, b⟩ in f32."""
    return sum(torch.dot(a[n].reshape(-1).to(torch.float32),
                         b[n].reshape(-1).to(torch.float32))
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
      kernel per leaf with ``use_agg_kernel``), then the cosines.
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
    (once per leaf; the plain weighted sum otherwise);
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
                        compression=None, server_opt=None, kernels=kops):
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
      kernel per leaf when ``use_agg_kernel`` (see
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
    """
    spec = CompressionSpec.parse(compression)
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
            batch = device_data.gather_batches(data, rows, pos_u[t])
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
