"""The port's device rule and its convolution numerics, shared by every
entry point."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for but absent:
    the port never drifts onto the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def conv_numerics():
    """Context that pins cuDNN's convolutions to full f32 with
    deterministic algorithms for the calls inside it, and puts the
    caller's settings back on leaving.

    PyTorch's defaults let cuDNN run f32 convolutions in TF32 (about
    three decimal digits) and pick algorithms whose sums change order
    from run to run. The reference's rounds repeat bit for bit on a
    given backend, so every round, chunk and evaluation of the CNN
    planes (``fl.round``, ``fl.simulation``) runs inside this scope.
    ``cudnn.flags`` saves and restores every flag it sets, the newer
    ``fp32_precision`` setting included, so nothing changes for code
    outside the scope. Matmuls are left alone: their f32 default is
    already full precision.
    """
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)
