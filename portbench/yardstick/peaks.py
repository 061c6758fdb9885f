"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit)."""

PEAK_BYTES_PER_S = 3.35e12        # HBM3
PEAK_BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
PEAK_F32_FLOPS = 67e12            # CUDA cores, f32


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS
            ) -> tuple[float, str]:
    """The least time the card could take for ``flops`` operations and
    ``nbytes`` bytes, and which of the two bounds it."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
