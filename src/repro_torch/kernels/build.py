"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` (CUDA C++ for ``sm_90a``, each with a plain C
interface) is compiled at first use by a single ``nvcc`` call into one
shared library under the checkout's git-ignored ``build/kernels/``,
named by a hash of all the sources, and loaded with ``ctypes``. Nothing
is built or loaded at import, so the CPU tests import the bindings
freely. Each binding module (``fedavg_agg``, ``segmented_topk``,
``mkp_utility``) sets the argument types of its own symbols.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


def sources() -> list[Path]:
    """Every kernel source, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "port's CUDA kernels cannot be built")


def _lib_path() -> Path:
    """The library built from the current sources (named by their hash)."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile every kernel source (once per version of the sources) in
    one ``nvcc`` call and load the library.

    ``nvcc -Xptxas -v`` output (registers, shared memory, spills of
    every entry) is kept beside the library as ``<name>.log``.
    Concurrent builds each write a temporary file and rename it into
    place.
    """
    lib_path = _lib_path()
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current sources' build."""
    return _lib_path().with_suffix(".log").read_text()


@functools.cache
def entry(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C function ``name`` of the library, typed: ``argtypes`` and
    then the stream handle; it returns a ``cudaError_t``."""
    fn = getattr(library(), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn: ctypes._CFuncPtr, device, *args) -> None:
    """Call a typed entry on ``device`` and PyTorch's current stream
    there; raise if it reports a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
