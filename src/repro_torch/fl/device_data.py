"""Device-resident FL data plane: staged dataset + on-device batch gather.

The partitioned dataset is staged on the device once, and every round
draws its client batches there, so a whole chunk of rounds runs with no
per-round host transfers (fl.round.make_fl_rounds_scan):

- :func:`repro_torch.fl.partition.dense_index_pools` turns the ragged
  per-client index lists into a dense ``(n_clients, cap)`` pool matrix;
- :class:`DeviceDataset` holds images/labels/pools/sizes as tensors on
  one device;
- :func:`sample_positions` derives per-round, per-slot randomness by
  key folding (:mod:`repro_torch.random`, bit-exact with the
  reference's ``jax.random``). Randomness is *slot-keyed* (one fold per
  client slot), so the draw for slot k is independent of how far the
  subset is padded;
- :func:`gather_batches` maps sampled positions to samples with two
  chained gathers (pool row -> sample index -> image);
- :func:`dropout_mask` draws the paper's per-round client dropout
  (behavior b_t = 0) on the device, keeping at least one client per
  round (slot 0 always holds a real client).

:class:`DeviceLMDataset` and :func:`gather_lm_batches` are the token
twins of the image dataset and gather, for the federated LM task
(fl.transformer_task).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.fl.partition import dense_index_pools


class DeviceDataset(NamedTuple):
    """Partitioned dataset staged on one device."""
    images: torch.Tensor     # (N, H, W, C) float32
    labels: torch.Tensor     # (N,) int64
    pools: torch.Tensor      # (n_clients, cap) int64 sample-index pools
    sizes: torch.Tensor      # (n_clients,) int64 true pool sizes

    @classmethod
    def stage(cls, data, parts, device, cap: int | None = None
              ) -> "DeviceDataset":
        """One-time host->device staging of a partitioned dataset;
        ``cap`` fixes the pools' width (:func:`dense_index_pools`, which
        raises when a client holds more samples)."""
        pools, sizes = dense_index_pools(parts, cap=cap)
        return cls(torch.as_tensor(np.asarray(data.images), device=device),
                   torch.as_tensor(np.asarray(data.labels, np.int64),
                                   device=device),
                   torch.as_tensor(pools.astype(np.int64), device=device),
                   torch.as_tensor(sizes.astype(np.int64), device=device))

    @property
    def n_clients(self) -> int:
        return self.pools.shape[0]


def slot_keys(base_key: torch.Tensor, round_index, slots: torch.Tensor
              ) -> torch.Tensor:
    """Keys for (round, client-slot): fold round then slot. ``round_index``
    is an int or an int64 tensor of any shape R; returns ``(*R, K, 2)``."""
    rk = trandom.fold_in(base_key, round_index)
    return trandom.fold_in(rk.unsqueeze(-2), slots)


def sample_positions(base_key, round_index, n_slots: int, local_steps: int,
                     batch_size: int, slot_offset: int = 0):
    """Per-slot uniforms: ``(mask_u (*R, K), pos_u (*R, K, E, b))``.

    ``mask_u`` drives the dropout draw, ``pos_u`` the batch-position
    draw. Values for slot k depend only on (base_key, round, k), never
    on ``n_slots``, so padding the subset does not perturb the stream.
    ``round_index`` may be a tensor of rounds (shape R), which draws a
    whole chunk at once.

    ``slot_offset`` shifts the slot ids: the client-sharded round scan
    (``fl.round.make_fl_rounds_scan_sharded``) passes each shard's first
    global slot, so every shard draws its global slots' stream, the
    slice ``[o:o + n_slots]`` of an unsharded draw.
    """
    slots = torch.arange(slot_offset, slot_offset + n_slots,
                         dtype=torch.int64, device=base_key.device)
    ku_kb = trandom.split(slot_keys(base_key, round_index, slots))
    return (trandom.uniform(ku_kb[..., 0, :], ()),
            trandom.uniform(ku_kb[..., 1, :], (local_steps, batch_size)))


def positions_to_indices(pools, sizes, rows, pos_u):
    """Map uniform draws to sample indices: ``(K, E, b)`` int64.

    pos = floor(u * size_k) in [0, size_k) — sampling with replacement
    from the client's true pool; dense-pool padding never selected.
    """
    sz = sizes[rows].to(torch.float32)[:, None, None]         # (K, 1, 1)
    pos = torch.floor(pos_u * sz).to(torch.int64)
    pos = torch.minimum(pos, (sz - 1).to(torch.int64))
    pos = torch.clamp_min(pos, 0)                              # empty pool
    rowpools = pools[rows]                                     # (K, cap)
    flat = torch.gather(rowpools, 1, pos.reshape(pos.shape[0], -1))
    return flat.reshape(pos.shape)


def to_device(data, device):
    """A staged dataset (either kind) with every tensor on ``device``;
    the same tensors where they are there already."""
    return type(data)(*(t.to(device) for t in data))


def gather_batches(data: DeviceDataset, rows, pos_u):
    """On-device batch assembly:
    ``{"images": (K,E,b,H,W,C), "labels": (K,E,b)}``."""
    idx = positions_to_indices(data.pools, data.sizes, rows, pos_u)
    flat = idx.reshape(-1)
    K, E, b = idx.shape
    imgs = data.images[flat].reshape(K, E, b, *data.images.shape[1:])
    labs = data.labels[flat].reshape(K, E, b)
    return {"images": imgs, "labels": labs}


class DeviceLMDataset(NamedTuple):
    """Token-sequence twin of :class:`DeviceDataset` for the federated
    LM plane (fl.transformer_task): ``seqs`` holds packed next-token
    sequences of length S+1 (input = ``[:, :-1]``, target = ``[:, 1:]``)
    as ``data.synthetic.make_lm_data`` makes them. Pools and sizes mean
    what they mean for images, so :func:`sample_positions` and
    :func:`positions_to_indices` serve both planes."""
    seqs: torch.Tensor       # (N, S+1) int64 packed token sequences
    labels: torch.Tensor     # (N,) int64 latent class (partitioning only)
    pools: torch.Tensor      # (n_clients, cap) int64 sample-index pools
    sizes: torch.Tensor      # (n_clients,) int64 true pool sizes

    @classmethod
    def stage(cls, data, parts, device, cap: int | None = None
              ) -> "DeviceLMDataset":
        """Stage ``data.synthetic.LMData`` (``.tokens``/``.labels``);
        ``cap`` as for :meth:`DeviceDataset.stage`."""
        pools, sizes = dense_index_pools(parts, cap=cap)
        as_i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                           device=device)
        return cls(as_i64(data.tokens), as_i64(data.labels), as_i64(pools),
                   as_i64(sizes))

    @property
    def n_clients(self) -> int:
        return self.pools.shape[0]


def gather_lm_batches(data: DeviceLMDataset, rows, pos_u):
    """LM batch assembly for ``make_fl_rounds_scan(gather_fn=...)``:
    ``{"tokens": (K,E,b,S), "targets": (K,E,b,S)}`` int64 (the
    models.transformer.loss_fn batch contract, next-token shifted)."""
    idx = positions_to_indices(data.pools, data.sizes, rows, pos_u)
    K, E, b = idx.shape
    seqs = data.seqs[idx.reshape(-1)].reshape(K, E, b, data.seqs.shape[1])
    return {"tokens": seqs[..., :-1], "targets": seqs[..., 1:]}


def dropout_mask(mask_u, active, dropout_rate: float, arrival=None):
    """Per-round client dropout mask (K,) f32.

    A client drops when its uniform < dropout_rate. ``active`` (K,) f32
    marks real (non-padding) slots. If every active client would drop,
    slot 0 is kept (schedules place real clients first).

    ``arrival`` (K,) f32, when given, also masks the clients that had not
    reported by the round's collect close (the lifecycle's fault mode):
    a client that did not arrive can neither contribute nor be the
    fallback, so the fallback becomes the first arrived active slot (and
    no slot when none arrived; the lifecycle dispatches only rounds that
    met their quorum). With ``arrival=None`` the computation is the
    no-fault one.
    """
    act = active > 0
    slots = torch.arange(mask_u.shape[0], device=mask_u.device)
    if arrival is None:
        fallback = (slots == 0) & act
    else:
        act = act & (arrival > 0)
        fallback = (slots == torch.argmax(act.to(torch.int32))) & act
    keep = (mask_u >= dropout_rate) & act
    keep = torch.where(keep.any(), keep, fallback)
    return keep.to(torch.float32)
