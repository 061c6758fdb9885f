"""The paper's experiment model: a small CNN classifier for MNIST-like
(1x28x28) and CIFAR-like (3x32x32) data (paper §VIII), in PyTorch.

Two conv blocks (3x3 SAME conv, ReLU, 2x2 max-pool) and two dense
layers, as in the JAX package's ``models.cnn``. ``forward`` and
``loss_fn`` take its ``impl`` argument, which picks the lowering:

- ``"reference"`` (the default): ``F.conv2d`` and ``F.max_pool2d``,
  which cuDNN runs on the card;
- ``"fast"``: the same math lowered as the reference's ``"fast"``: each
  3x3 conv as nine shifted slices and one matmul (im2col), and the 2x2
  pool as a reshape and a max (``amax``, whose gradient splits evenly
  between tied maxima as JAX's ``max`` does);
- ``"auto"``: what the reference means by it, the tuned native path on
  the accelerator and ``"fast"`` off it. The reference resolves it to
  ``"reference"`` on a TPU, where XLA's native convolution is the tuned
  one, and to ``"fast"`` elsewhere, because XLA's CPU convolution and
  its pool gradient are slow. On the card the tuned native path is
  cuDNN, so here ``"auto"`` is ``"reference"`` for a CUDA tensor and
  ``"fast"`` for a CPU tensor.

The public surface keeps the JAX layout, so parameters and images
carry across unchanged: images are NHWC, conv weights HWIO, dense
weights ``(in, out)``. :func:`forward` permutes to PyTorch's NCHW/OIHW
inside, in one place, and permutes back to NHWC before the flatten
that feeds ``fc1``: the reference flattens over (H, W, C), and a plain
NCHW flatten (C, H, W) would silently scramble ``fc1``.

Parameters are a flat ``dict[str, Tensor]`` keyed ``"<layer>.<w|b>"``
(the names of :class:`CNN`'s ``named_parameters``), so the round plane
can differentiate and ``vmap`` plain functions of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYERS = ("conv1", "conv2", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "cnn-mnist"
    height: int = 28
    width: int = 28
    channels: int = 1
    num_classes: int = 10
    conv1: int = 16
    conv2: int = 32
    hidden: int = 128
    dtype: str = "float32"


MNIST_CNN = CNNConfig()
CIFAR_CNN = CNNConfig(name="cnn-cifar", height=32, width=32, channels=3,
                      conv1=32, conv2=64, hidden=256)


def param_shapes(cfg: CNNConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter, in the JAX layout."""
    flat = (cfg.height // 4) * (cfg.width // 4) * cfg.conv2  # two 2x2 pools
    return {"conv1.w": (3, 3, cfg.channels, cfg.conv1), "conv1.b": (cfg.conv1,),
            "conv2.w": (3, 3, cfg.conv1, cfg.conv2), "conv2.b": (cfg.conv2,),
            "fc1.w": (flat, cfg.hidden), "fc1.b": (cfg.hidden,),
            "fc2.w": (cfg.hidden, cfg.num_classes),
            "fc2.b": (cfg.num_classes,)}


def init_params(cfg: CNNConfig, generator: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """He-normal conv weights, 1/sqrt(fan_in) dense weights, zero biases
    (the reference's scales; the draws are torch's, not JAX's)."""
    dt = getattr(torch, cfg.dtype)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".b"):
            out[name] = torch.zeros(shape, dtype=dt, device=device)
            continue
        fan_in = int(np.prod(shape[:-1]))
        scale = (2.0 / fan_in) ** 0.5 if name.startswith("conv") \
            else fan_in ** -0.5
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        out[name] = (w * scale).to(dtype=dt, device=device)
    return out


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's nested ``{"conv1": {"w", "b"}, ...}`` parameter
    tree (numpy arrays) -> this module's flat dict. Same layouts, so
    this copies: it checks names and shapes and permutes nothing."""
    if set(tree) != set(LAYERS):
        raise ValueError(f"expected layers {LAYERS}, got {sorted(tree)}")
    out = {}
    for layer in LAYERS:
        if set(tree[layer]) != {"w", "b"}:
            raise ValueError(f"layer {layer!r} needs exactly 'w' and 'b'")
        for leaf in ("w", "b"):
            out[f"{layer}.{leaf}"] = torch.tensor(np.asarray(tree[layer][leaf]))
    w1, w2 = out["conv1.w"], out["conv2.w"]
    if w1.ndim != 4 or w2.ndim != 4 or w1.shape[:2] != (3, 3) \
            or w2.shape[2] != w1.shape[3]:
        raise ValueError("conv weights must be HWIO 3x3 and chain")
    for layer in LAYERS:
        if out[f"{layer}.b"].shape != (out[f"{layer}.w"].shape[-1],):
            raise ValueError(f"layer {layer!r}: bias does not match weight")
    return out


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: flat dict -> nested numpy
    tree in the reference's layout."""
    return {layer: {leaf: params[f"{layer}.{leaf}"].detach().cpu().numpy()
                    for leaf in ("w", "b")} for layer in LAYERS}


def _conv_block(x, w, b):
    """NCHW x, HWIO w: 3x3 SAME conv + ReLU + 2x2 VALID max-pool."""
    y = F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1))
    return F.max_pool2d(y, 2)


def _conv_im2col(x, w):
    """NHWC x, HWIO w: 3x3 SAME conv as nine shifted slices and one
    matmul, the patches ordered (row, column, channel) as w's first
    three axes."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + H, j:j + W, :] for i in range(3) for j in range(3)]
    patches = torch.cat(cols, dim=-1).reshape(B * H * W, 9 * C)
    return (patches @ w.reshape(9 * C, -1)).reshape(B, H, W, -1)


def _pool_reshape(y):
    """NHWC 2x2 VALID max-pool as a reshape and a max (odd trailing rows
    and columns dropped, as VALID windows drop them)."""
    B, H, W, C = y.shape
    y = y[:, :H - H % 2, :W - W % 2, :]
    return y.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"reference"`` on CUDA (cuDNN), ``"fast"`` elsewhere."""
    if impl == "auto":
        return "reference" if device.type == "cuda" else "fast"
    if impl not in ("reference", "fast"):
        raise ValueError(f"unknown cnn impl {impl!r}")
    return impl


def forward(cfg: CNNConfig, params, images, impl: str = "reference"):
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    if resolve_impl(impl, images.device) == "fast":
        x = images
        for layer in ("conv1", "conv2"):
            x = _pool_reshape(F.relu(_conv_im2col(x, params[f"{layer}.w"])
                                     + params[f"{layer}.b"]))
        x = x.reshape(x.shape[0], -1)                    # flatten (H, W, C)
    else:
        x = images.permute(0, 3, 1, 2)                   # NHWC -> NCHW
        x = _conv_block(x, params["conv1.w"], params["conv1.b"])
        x = _conv_block(x, params["conv2.w"], params["conv2.b"])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten (H, W, C)
    x = F.relu(x @ params["fc1.w"] + params["fc1.b"])
    return x @ params["fc2.w"] + params["fc2.b"]


def loss_fn(cfg: CNNConfig, params, batch, impl: str = "reference"):
    """batch: images (B,H,W,C), labels (B,), weights optional (B,).
    Returns ``(loss, {"loss", "accuracy"})``."""
    logits = forward(cfg, params, batch["images"], impl=impl)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, 1, batch["labels"][:, None])[:, 0]
    w = batch.get("weights")
    loss = nll.mean() if w is None \
        else (nll * w).sum() / torch.clamp_min(w.sum(), 1e-9)
    acc = (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
    return loss, {"loss": loss, "accuracy": acc}


class CNN(nn.Module):
    """The CNN as an ``nn.Module``; its ``named_parameters`` are the
    flat dict that :func:`forward` and :func:`loss_fn` take."""

    def __init__(self, cfg: CNNConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for layer in LAYERS:
            mod = nn.Module()
            mod.w = nn.Parameter(params[f"{layer}.w"])
            mod.b = nn.Parameter(params[f"{layer}.b"])
            setattr(self, layer, mod)

    def forward(self, images):
        return forward(self.cfg, dict(self.named_parameters()), images)
