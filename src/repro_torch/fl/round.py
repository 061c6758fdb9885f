"""The device-resident round data plane in PyTorch.

``make_fl_rounds_scan`` builds the chunk function of the paper's FedAvg
rounds: S rounds per call over precomputed schedule tensors (padded
subsets/weights from stage 2). Each round draws its client batches and
dropout mask on the device (fl.device_data), runs E local SGD steps per
client with ``torch.func`` (``grad`` inside ``vmap`` over the client
axis), and applies the fused aggregation + quality pass
(kernels.ops.fedavg_agg_quality: one read of the stacked deltas yields
Δ_t and every q_t cosine), then the server step w_{t+1} = w_t − η Δ_t
(paper §III). Nothing in here forces a result to the host, so on the
card a chunk is enqueued and the caller decides when to block.

Parameters are flat ``dict[str, Tensor]`` (models.cnn). Leaves are
ordered by sorted name, which is JAX's pytree order for the reference's
nested dicts (``b`` before ``w``), so the flattened (K, P) matrix has
the reference's column order.

Not ported yet (ROADMAP.md Queue 1): the compressed update plane,
server optimizers, fault-mode arrival masks, the client-sharded scan
and the FedSGD step; asking for any of them raises.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.fl import device_data
from repro_torch.kernels import ops as kops


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


def aggregate_and_quality(deltas, w, aggregate: Callable):
    """Weighted aggregate Δ_t + per-client q_t = cos(Δ_t^(k), Δ_t) from
    one fused pass over the flattened deltas."""
    flat, unflatten = flatten_stacked(deltas)
    agg_flat, dots, sq, asq = aggregate(flat, w)
    q = dots / torch.clamp_min(torch.sqrt(sq) * torch.sqrt(asq), 1e-12)
    return unflatten(agg_flat), q


def make_fl_rounds_scan(loss_fn: Callable, local_lr: float = 0.05,
                        local_steps: int = 1, batch_size: int = 16,
                        server_lr: float = 1.0, dropout_rate: float = 0.0,
                        compression=None, server_opt=None,
                        aggregate: Callable = kops.fedavg_agg_quality):
    """Chunked multi-round function: S rounds per call.

    Returns ``chunk_fn(params, data, schedule, base_key)`` where

    - ``params`` is the flat parameter dict (not modified; a new dict
      comes back),
    - ``data`` is a :class:`repro_torch.fl.device_data.DeviceDataset`,
    - ``schedule`` is a dict of stacked per-round tensors from stage 2:
      ``rows (S, K)`` int64 positions into the dataset pools, ``weights
      (S, K)`` f32 FedAvg p_k, ``active (S, K)`` f32 padding mask
      (subsets sized n±δ are padded to a static K with actives first),
      ``round_ids (S,)`` int64 global round indices,
    - ``base_key`` is a :mod:`repro_torch.random` key that seeds batch
      sampling + dropout via per-(round, slot) key folds.

    Outputs stack across the chunk: ``(params', {"masks": (S,K),
    "q_values": (S,K), "client_losses": (S,K), "mean_loss": (S,)})``.

    ``aggregate`` is the fused pass (the kernel wrapper); a caller may
    hand in its plain version to hold the two against each other.
    """
    if compression not in (None, "none"):
        raise NotImplementedError("the compressed update plane is not ported "
                                  "yet: ROADMAP.md Queue 1 item 7")
    if server_opt is not None:
        raise NotImplementedError("server optimizers are not ported yet: "
                                  "ROADMAP.md Queue 1 item 3")
    client_update = torch.func.vmap(
        _make_client_update(loss_fn, local_lr, local_steps),
        in_dims=(None, 0))

    @torch.no_grad()
    def chunk_fn(params, data, schedule, base_key):
        if "arrival" in schedule:
            raise NotImplementedError("fault-mode arrival masks are not "
                                      "ported yet: ROADMAP.md Queue 1 item 5")
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
            agg, q = aggregate_and_quality(deltas, w, aggregate)
            params = {n: (p - server_lr * agg[n]).to(p.dtype)
                      for n, p in params.items()}
            infos.append({"masks": mask, "q_values": q * mask,
                          "client_losses": losses,
                          "mean_loss": (losses * w).sum()})
        return params, {k: torch.stack([i[k] for i in infos])
                        for k in infos[0]}

    return chunk_fn
