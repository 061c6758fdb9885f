"""Host-side checks for the Hopper kernels that read their operands
through TMA tensor maps, the Python counterpart of ``csrc/hopper.cuh``."""
from __future__ import annotations

import torch


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map can describe ``t`` (B, heads, S, hd) in
    place: its first element on a 16-byte boundary, hd contiguous and
    every other stride a positive multiple of 16 bytes below 2**40 bytes
    (a unit axis takes any stride). Otherwise the wrapper copies it."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(n == 1 or (0 < st * size < 2 ** 40 and st * size % 16 == 0)
                    for n, st in zip(t.shape[:3], t.stride()[:3])))
