"""Counter-based random draws, bit-exact with JAX's default PRNG.

The reference keys every batch and dropout draw by ``(seed, round,
slot)`` through ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable=True``, the default of jax 0.9). A draw
for slot k then depends only on (seed, round, k), so padding the client
axis or cutting a period into chunks leaves the draws unchanged. A
sequential ``torch.Generator`` cannot keep that property, and it cannot
reproduce the reference's batches, so this module ports the four
functions the round plane uses: :func:`prng_key`, :func:`fold_in`,
:func:`split` and :func:`uniform`.

A key is an int64 tensor of shape ``(..., 2)`` holding two 32-bit words
(the JAX key data); leading dimensions batch independent keys. All
arithmetic runs on int64 tensors masked to 32 bits, so it runs the same
on the CPU and on the card.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function (20 rounds), elementwise over
    broadcast int64 tensors of 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key data: ``(2,)`` int64."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, hi, lo) -> torch.Tensor:
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key ``(..., 2)``, non-negative int32
    ``data`` (a Python int or an int64 tensor broadcasting against the
    key's leading dimensions) -> key ``(..., 2)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _hash(key, torch.zeros_like(data), data & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key ``(..., 2)`` ->
    ``(..., num, 2)``; subkey i hashes the counter pair (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key.unsqueeze(-2), torch.zeros_like(i), i)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words ``(..., *shape)`` (JAX's partitionable
    ``random_bits``: the flat index is the 64-bit counter, and the two
    output words are xor-ed)."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key.reshape(*key.shape[:-1], *([1] * len(shape)), 2)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], (idx >> 32).reshape(shape),
                          (idx & _MASK).reshape(shape))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32: the top 23
    bits become the mantissa of a float in [1, 2), minus one."""
    bits = random_bits(key, tuple(shape))
    one = (bits >> 9) | 0x3F800000
    return torch.clamp_min(one.to(torch.int32).view(torch.float32) - 1.0, 0.0)
