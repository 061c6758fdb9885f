"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` (CUDA C++ for ``sm_90a``, each with a plain C
interface) is compiled at first use, one ``nvcc`` process per source,
all started together, and the objects are linked by one more ``nvcc``
call into one shared library under the checkout's git-ignored
``build/kernels/``, named by a hash of all the sources and of the
headers they include (``csrc/*.cuh``), and loaded with
``ctypes``. Nothing is built or loaded at import, so the CPU tests
import the bindings freely. Each binding module (``fedavg_agg``,
``segmented_topk``, ``mkp_utility``, ``compression``) sets the argument
types of its own symbols.
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


def headers() -> list[Path]:
    """Every header the sources include (``csrc/*.cuh``), in a fixed order."""
    return sorted(CSRC.glob("*.cuh"))


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
    """The library built from the current sources and headers (named by
    their hash, so an edit to either builds anew)."""
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile every kernel source (once per version of the sources),
    each in its own ``nvcc`` process, link them and load the library.

    ``nvcc -Xptxas -v`` output (registers, shared memory, spills of
    every entry) is kept beside the library as ``<name>.log``.
    Concurrent builds each write temporary files and rename the library
    into place.
    """
    lib_path = _lib_path()
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib_path.stem}.{os.getpid()}"
        arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
        objs, procs = [], []
        for src in sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, log) for src, p, log
                  in zip(sources(), procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        tmp = lib_path.with_name(f"{tag}.so.tmp")
        proc = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        for obj in objs:
            obj.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        lib_path.with_suffix(".log").write_text("".join(logs))
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


def aligned16(*tensors) -> bool:
    """Every tensor starts on a 16-byte boundary (for 16-byte loads)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch(fn: ctypes._CFuncPtr, device, *args) -> None:
    """Call a typed entry on ``device`` and PyTorch's current stream
    there; raise if it reports a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    import torch
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
