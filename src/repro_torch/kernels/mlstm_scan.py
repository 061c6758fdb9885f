"""Bind the chunkwise gated linear attention CUDA kernels
(``csrc/mlstm_scan.cu``).

They replace the JAX package's Pallas kernel
``kernels/mlstm_scan.py::mlstm_scan`` (mLSTM with input gates and a
normalizer; the SSD form of Hymba's mamba heads), with the semantics of
its oracle ``models.ssm.gated_linear_attention``, and also return the
final state that prefill keeps for decode. :func:`route` picks one of two
routes (see the source for the bound and the designs): ``"wgmma"`` (bf16:
chunk-parallel on the tensor cores: a gate pass, every chunk's own state
update at once, a chain pass that adds them up and writes the state
entering each chunk in f32 to a workspace, and an output pass over every
chunk at once, each f32 operand of a product split into three exact bf16
terms) and ``"simple"`` (f32, and bf16 shapes the first does
not take: one block walks the chunks, f32 FMA). Built with the port's
other kernels at first use (:mod:`repro_torch.kernels.build`); nothing is
built or loaded at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .tma import tma_describable

MAX_DK = 512
MAX_CHUNK = 256
TILE = 64       # the chunked route's tiles: rows, keys, dk and dv columns
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_longlong,) * 18
             + (ctypes.c_int,) * 8)
_CHUNKED_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.c_longlong,) * 18
                     + (ctypes.c_int,) * 7)
# Launches by route since the counts were last set to 0 (one a call: the
# route the wrapper took, after any copy of its operands).
ROUTES = {"wgmma": 0, "simple": 0}


def route(dtype: torch.dtype, dk: int, dv: int, chunk: int,
          describable: bool = True) -> str:
    """The kernel a call takes: "wgmma" (the chunk-parallel route) for
    bf16 with dk and dv multiples of 8, a chunk that is a multiple of
    ``TILE`` and q, k, v that TMA maps can describe in place
    (``describable``: see :func:`tma.tma_describable`); else
    "simple" (the one-block-a-head FMA kernel), as for every f32 call."""
    if (dtype == torch.bfloat16 and dk % 8 == 0 and dv % 8 == 0
            and chunk % TILE == 0 and describable):
        return "wgmma"
    return "simple"


def workspace(B: int, H: int, S: int, dk: int, dv: int, chunk: int) -> int:
    """The chunked route's scratch in f32 elements: each chunk's own
    update of S and of n (B H NC dk dv and B H NC dk, NC = ceil(S /
    chunk)), which the chain pass overwrites with the state entering the
    chunk; the gate pass's four planes of B H NC chunk values; the
    stabilizer entering each chunk and the final one, and each chunk's
    decay. About 4 (dk dv + dk) / chunk + 16 bytes a token and head: 76
    MB at xLSTM-125M's prefill (4 x 2,048 tokens, 4 heads, 384 / 384,
    chunks of 256), 6.6 MB at Hymba-1.5B's."""
    bh, nc = B * H, -(-S // chunk)
    return (bh * nc * (dk * dv + dk) + 4 * bh * nc * chunk + bh * (nc + 1)
            + bh * nc)


def _state_in(state, B, H, dk, dv, device):
    """The initial state as contiguous f32 (S, n, m), or Nones."""
    if state is None:
        return None, None, None
    shapes = {"S": (B, H, dk, dv), "n": (B, H, dk), "m": (B, H)}
    out = []
    for name, shape in shapes.items():
        t = state[name]
        if tuple(t.shape) != shape or t.device != device:
            raise ValueError(f"mlstm_scan initial_state[{name!r}] must be "
                             f"{shape} on {device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t.to(torch.float32).contiguous())
    return tuple(out)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_f: torch.Tensor, log_i: torch.Tensor | None = None, *,
               chunk: int = 64, normalize: bool = True, initial_state=None):
    """Launch the kernel. q, k: (B, H, S, dk), v: (B, H, S, dv), CUDA
    tensors of one type (float32 or bfloat16), any strides but a
    contiguous last axis (others are copied); log_f and log_i (B, H, S)
    float32, any strides, ``log_i=None`` for the SSD form; dk <= 512,
    chunk <= 256. Returns ``(out (B, H, S, dv) with v's strides, {S, n,
    m} f32)`` as :func:`repro_torch.kernels.ref.mlstm_scan_state_ref`
    defines them; the route is :func:`route`'s, counted in ``ROUTES``.
    Raises on any input the kernel does not take and on a failed
    launch."""
    dev = q.device
    gates = (log_f,) if log_i is None else (log_f, log_i)
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, *gates)):
        raise ValueError("mlstm_scan kernel needs q, k, v and the gates on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm_scan takes float32 or bfloat16 q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in gates):
        raise ValueError(f"mlstm_scan takes float32 gates, got "
                         f"{[t.dtype for t in gates]}")
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:3] != q.shape[:3] \
            or any(t.shape != q.shape[:3] for t in gates):
        raise ValueError(f"mlstm_scan takes q, k (B, H, S, dk), v (B, H, S, "
                         f"dv) and gates (B, H, S), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{[tuple(t.shape) for t in gates]}")
    B, H, S, dk = q.shape
    dv = v.shape[3]
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"mlstm_scan takes 1 <= dk <= {MAX_DK}, got {dk}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"mlstm_scan takes 1 <= chunk <= {MAX_CHUNK}, got "
                         f"{chunk}")
    if min(B, H, S, dv) < 1 or B * H >= 2 ** 31 or S >= 2 ** 31 \
            or dv > 64 * 65535:
        raise ValueError(f"mlstm_scan takes B, H, S, dv >= 1 within the "
                         f"grid's limits, got {(B, H, S, dv)}")
    ready = lambda t: t if t.stride(3) == 1 else t.contiguous()
    q, k, v = ready(q), ready(k), ready(v)
    kind = route(q.dtype, dk, dv, chunk,
                 all(tma_describable(t) for t in (q, k, v)))
    out = torch.empty_like(v)           # v's layout: (B, S, H, dv) views stay so
    S0, n0, m0 = _state_in(initial_state, B, H, dk, dv, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    S1 = torch.empty((B, H, dk, dv), **f32)
    n1 = torch.empty((B, H, dk), **f32)
    m1 = torch.empty((B, H), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    i_strides = (0, 0, 0) if log_i is None else log_i.stride()
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            ptr(log_i), out.data_ptr(), ptr(S0), ptr(n0), ptr(m0),
            S1.data_ptr(), n1.data_ptr(), m1.data_ptr()]
    tail = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *log_f.stride(), *i_strides,
            B, H, S, dk, dv, int(chunk), int(bool(normalize))]
    if kind == "wgmma":
        # scratch from the caching allocator, written before it is read:
        # no memset, so the call replays in a CUDA graph
        ws = torch.empty(workspace(B, H, S, dk, dv, chunk), **f32)
        build.launch(build.entry("mlstm_scan_chunked", _CHUNKED_ARGTYPES),
                     dev, *head, ws.data_ptr(), *tail)
    else:
        build.launch(build.entry("mlstm_scan_fwd", _ARGTYPES), dev, *head,
                     *tail, _DTYPES[q.dtype])
    ROUTES[kind] += 1
    return out, {"S": S1, "n": n1, "m": m1}
