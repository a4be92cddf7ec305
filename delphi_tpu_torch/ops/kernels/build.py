"""Build and ctypes binding of the port's CUDA kernels.

The sources are ``delphi_tpu_torch/csrc/*.cu``. At first use each source
compiles with ``nvcc`` for ``sm_90a`` (all sources at once, one ``nvcc``
each), then they link into one shared library under ``build/delphi_tpu_torch``
at the repo root. The library's file name carries a hash of the sources and
flags, so an edited source never loads a stale build. Each kernel's C
entry point takes a host pointer to its parameter table (a ``ctypes``
structure the kernel receives by value) and the stream as ``void*``, and
returns the first ``cudaError_t`` it met; :func:`check` raises on a
non-zero code. No entry point waits for the device.

A failed build raises :class:`KernelBuildError` and a failed launch
:class:`KernelLaunchError`: the resilience plane classifies neither as a
fault, so neither is retried or sent down the degradation ladder.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "delphi_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or compiling or linking a source failed."""


class KernelLaunchError(RuntimeError):
    """A kernel's entry point returned a CUDA error."""


def sources() -> List[str]:
    return sorted(os.path.join(_CSRC_DIR, f) for f in os.listdir(_CSRC_DIR)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path() -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libdelphi_kernels_{digest.hexdigest()[:12]}.so")


def build(ptxas_verbose: bool = False) -> Tuple[str, str]:
    """Compiles the sources (skipped when the hashed library exists and
    ``ptxas_verbose`` is off). Returns (library path, compiler output)."""
    lib_path = _library_path()
    if os.path.exists(lib_path) and not ptxas_verbose:
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas=-v"] if ptxas_verbose else []
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    failed = []
    for src, proc in zip(sources(), procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise KernelBuildError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise KernelBuildError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path, "\n".join(logs + [link.stdout])


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            # (table pointer, grid, shared bytes, stream)
            lib.delphi_pair_counts.restype = i32
            lib.delphi_pair_counts.argtypes = [vp, i32, i32, vp]
            # (table pointer, stream)
            lib.delphi_entropy_terms.restype = i32
            lib.delphi_entropy_terms.argtypes = [vp, vp]
            lib.delphi_launch_floor.restype = i32
            lib.delphi_launch_floor.argtypes = [vp]
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{kernel}: CUDA launch failed (cudaError {err})")


def current_stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
