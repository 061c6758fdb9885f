"""The device-resident round data plane in PyTorch.

``make_fl_rounds_scan`` builds the chunk function of the paper's FedAvg
rounds: S rounds per call over precomputed schedule tensors (padded
subsets/weights from stage 2). Each round draws its client batches and
dropout mask on the device (fl.device_data), runs E local SGD steps per
client with ``torch.func`` (``grad`` inside ``vmap`` over the client
axis), and applies the fused aggregation + quality pass
(kernels.ops.fedavg_agg_quality: one read of the stacked deltas yields
Δ_t and every q_t cosine), then the server step w_{t+1} = w_t − η Δ_t
(paper §III), or a server optimizer's step (FedAdam/FedYogi). With a
compression spec the server aggregates from the encoded deltas
(fl.compression). Nothing in here forces a result to the host, so on
the card a chunk is enqueued and the caller decides when to block.

Parameters are flat ``dict[str, Tensor]`` (models.cnn). Leaves are
ordered by sorted name, which is JAX's pytree order for the reference's
nested dicts (``b`` before ``w``), so the flattened (K, P) matrix has
the reference's column order.

Not ported yet (ROADMAP.md Queue 1): fault-mode arrival masks, the
client-sharded scan, the LM batch gather and the FedSGD step; asking
for arrival masks raises.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

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


def _make_client_update(loss_fn: Callable, local_lr: float, local_steps: int):
    """E local SGD steps for one client; returns (delta, mean_loss)."""
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def client_update(params, batches):
        p = params
        losses = []
        for e in range(local_steps):
            grads, (loss, _) = grad_fn(p, {k: v[e] for k, v in batches.items()})
            p = {n: p[n] - local_lr * grads[n] for n in p}
            losses.append(loss)
        return ({n: params[n] - p[n] for n in params},
                torch.stack(losses).mean())

    return client_update


def aggregate_and_quality(deltas, w, spec: CompressionSpec, kernels=kops):
    """Weighted aggregate Δ_t + per-client q_t = cos(Δ_t^(k), Δ_t) from
    one fused pass over the flattened deltas, or, when ``spec`` is
    active, from their encoded payloads (q on the decoded deltas).
    Returns ``(agg, q, per-client wire bytes or None)``."""
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


def make_fl_rounds_scan(loss_fn: Callable, local_lr: float = 0.05,
                        local_steps: int = 1, batch_size: int = 16,
                        server_lr: float = 1.0, dropout_rate: float = 0.0,
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
      ``round_ids (S,)`` int64 global round indices,
    - ``base_key`` is a :mod:`repro_torch.random` key that seeds batch
      sampling + dropout via per-(round, slot) key folds.

    Outputs stack across the chunk: ``(carry', {"masks": (S,K),
    "q_values": (S,K), "client_losses": (S,K), "mean_loss": (S,)})``.

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
    client_update = torch.func.vmap(
        _make_client_update(loss_fn, local_lr, local_steps),
        in_dims=(None, 0))

    @torch.no_grad()
    def chunk_fn(carry, data, schedule, base_key):
        if "arrival" in schedule:
            raise NotImplementedError("fault-mode arrival masks are not "
                                      "ported yet: ROADMAP.md Queue 1 item 5")
        params, opt_state = (carry, None) if server_opt is None else carry
        S, K = schedule["rows"].shape
        mask_u, pos_u = device_data.sample_positions(
            base_key, schedule["round_ids"], K, local_steps, batch_size)
        infos = []
        for t in range(S):
            rows = schedule["rows"][t]
            # a scheduled client with an empty pool cannot return an
            # update: treat its slot as inactive (b_t = 0, weight 0)
            active = schedule["active"][t] * (data.sizes[rows] > 0)
            mask = device_data.dropout_mask(mask_u[t], active, dropout_rate)
            batch = device_data.gather_batches(data, rows, pos_u[t])
            deltas, losses = client_update(params, batch)
            w = schedule["weights"][t] * mask
            w = w / torch.clamp_min(w.sum(), 1e-9)
            agg, q, per_client = aggregate_and_quality(deltas, w, spec,
                                                       kernels)
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
