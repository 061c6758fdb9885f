"""Build and bind the fused FedAvg aggregation + quality CUDA kernel.

The kernel (``csrc/fedavg_agg_quality.cu``, CUDA C++ for ``sm_90a``)
replaces the JAX package's Pallas kernel
``kernels/fedavg_agg.py::fedavg_agg_quality``: in one pass over the
stacked client deltas U (K, P) it yields the weighted aggregate Δ_t and
the Gram terms of every quality cosine q_t = cos(Δ_t^(k), Δ_t) (paper
§IV-C). It is bandwidth-bound; see the source for its bound and design.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface under the checkout's git-ignored ``build/``
directory, named by a hash of the source, and loaded with ``ctypes``.
Nothing is built or loaded at import, so the CPU tests import this
module freely.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "fedavg_agg_quality.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
MAX_K = 64               # the kernel's register tiles stop at 64 clients
THREADS = 256            # threads per block, as in the source
MAX_BLOCKS = 1024        # grid cap; the grid depends on P only
_SYMBOLS = {torch.float32: "fedavg_agg_quality_f32",
            torch.bfloat16: "fedavg_agg_quality_bf16"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "fedavg_agg_quality kernel cannot be built")


def _lib_path() -> Path:
    """The library built from the current source (named by its hash)."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfedavg_agg_quality-{tag}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it.

    ``nvcc -Xptxas -v`` output (registers, shared memory, spills) is kept
    beside the library as ``<name>.log``. Concurrent builds each write
    a temporary file and rename it into place.
    """
    lib_path = _lib_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in _SYMBOLS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.fedavg_agg_quality_max_k.restype = ctypes.c_int
    if lib.fedavg_agg_quality_max_k() != MAX_K:
        raise RuntimeError("kernel and binding disagree on the K maximum")
    return lib


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current source's build."""
    return _lib_path().with_suffix(".log").read_text()


def num_blocks(P: int) -> int:
    """Grid of the partials kernel: one block per 256 columns, capped."""
    return max(1, min(-(-P // THREADS), MAX_BLOCKS))


def fedavg_agg_quality(updates: torch.Tensor, weights: torch.Tensor):
    """Launch the kernel on CUDA tensors. updates: (K, P) f32/bf16,
    contiguous, 1 <= K <= ``MAX_K``; weights: (K,) (cast to f32).

    Returns ``(agg (P,) updates.dtype, dots (K,), sq (K,), asq ())`` as
    :func:`repro_torch.kernels.ref.fedavg_agg_quality_ref` defines them.
    Raises on any input the kernel does not take and on a failed launch.
    """
    if updates.device.type != "cuda":
        raise ValueError("fedavg_agg_quality kernel needs CUDA tensors")
    if updates.ndim != 2 or updates.dtype not in _SYMBOLS:
        raise ValueError("updates must be (K, P) float32 or bfloat16, got "
                         f"{tuple(updates.shape)} {updates.dtype}")
    K, P = updates.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"fedavg_agg_quality takes 1 <= K <= {MAX_K}, got {K}")
    if P < 1:
        raise ValueError("fedavg_agg_quality needs P >= 1")
    if not updates.is_contiguous():
        raise ValueError("updates must be contiguous")
    if weights.shape != (K,) or weights.device != updates.device:
        raise ValueError("weights must be (K,) on the updates' device")
    w = weights.to(torch.float32).contiguous()
    nb = num_blocks(P)
    dev = updates.device
    agg = torch.empty(P, dtype=updates.dtype, device=dev)
    part = torch.empty(nb * (2 * K + 1), dtype=torch.float32, device=dev)
    out = torch.empty(2 * K + 1, dtype=torch.float32, device=dev)
    fn = getattr(library(), _SYMBOLS[updates.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(updates.data_ptr(), w.data_ptr(), agg.data_ptr(),
                part.data_ptr(), part[nb * K:].data_ptr(),
                part[2 * nb * K:].data_ptr(), out.data_ptr(),
                K, P, nb, stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_agg_quality launch failed: CUDA error {rc}")
    return agg, out[:K], out[K:2 * K], out[2 * K]
