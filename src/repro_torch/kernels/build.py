"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (``extern "C"``
launch functions taking ``void*`` pointers, ints and the stream) and is
compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the
repository root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

``<hash>`` is a digest of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and a stale library is
never loaded.  A library is built at
its first use (or all at once, in parallel, by :func:`build_all`) and
loaded once per process.  No PyTorch header is included, so each source
builds in seconds.

Pointers and the stream cross as ``ctypes.c_void_p`` (never as the
default 32-bit int); every launch function returns its
``cudaGetLastError()`` and :func:`check` raises on a non-zero value.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]   # report registers / shared memory / spills
#: every source under csrc/, one library each
SOURCES = ("scaled_matmul", "acdc_cascade", "paged_attn",
           "acdc_cascade_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

VP = ctypes.c_void_p
I32 = ctypes.c_int
F32 = ctypes.c_float


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a machine with "
            "the CUDA toolkit (the CPU path uses the plain versions)")
    return path


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc in the background; returns (process, tmp, out) or
    None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every named library at once (one nvcc per source, all
    started together); returns each compiler's output (ptxas's register
    and shared-memory report included).  Raises with the compiler output
    if any build fails."""
    jobs = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            logs[name] = "(cached)"
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """A launch function of library ``name`` with its argument types
    declared (``int`` return: the launch's ``cudaGetLastError()``)."""
    f = getattr(load(name), fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t: Optional["object"]) -> Optional[int]:
    """``data_ptr()`` of a tensor, or None (a NULL pointer) for None."""
    return None if t is None else t.data_ptr()


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (the
    launch path's cheapest way to it: a few hundred ns, against ~4 us
    for ``torch.cuda.current_stream(device).cuda_stream``)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(
        torch.cuda._get_device_index(device, optional=True))
