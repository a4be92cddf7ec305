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
import time
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


def _library_name() -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            digest.update(f.read())
    return f"libdelphi_kernels_{digest.hexdigest()[:12]}.so"


def _library_path() -> str:
    return os.path.join(BUILD_DIR, _library_name())


def build(ptxas_verbose: bool = False,
          directory: Optional[str] = None) -> Tuple[str, str]:
    """Compiles the sources into ``directory`` (default :data:`BUILD_DIR`;
    skipped when the hashed library exists there and ``ptxas_verbose`` is
    off). Returns (library path, compiler output)."""
    lib_path = _library_path() if directory is None \
        else os.path.join(directory, _library_name())
    directory = os.path.dirname(lib_path)
    if os.path.exists(lib_path) and not ptxas_verbose:
        return lib_path, ""
    os.makedirs(directory, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas=-v"] if ptxas_verbose else []
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(directory, os.path.basename(src) + f".{os.getpid()}.o")
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


def _resolve_library() -> Tuple[str, bool]:
    """The library file to load and whether it is a private one, found
    through the compile plane's build cache
    (:mod:`delphi_tpu_torch.parallel.compile_plane`): the cache directory,
    one ``compile_cache.requests`` count and a hit or a miss. A miss
    builds in a private work directory inside the cache directory (so the
    move into the cache is one rename on one filesystem, atomic for
    concurrent loaders); the library then moves into the cache directory,
    unless it built faster than the cache's threshold, in which case it
    loads from the private file, deleted once loaded."""
    from delphi_tpu_torch.parallel import compile_plane
    from delphi_tpu_torch.utils import counter_inc
    directory = compile_plane.cache_dir() or BUILD_DIR
    cached = os.path.join(directory, _library_name())
    counter_inc("compile_cache.requests")
    if os.path.exists(cached):
        counter_inc("compile_cache.hits")
        return cached, False
    counter_inc("compile_cache.misses")
    work = os.path.join(directory, f".work-{os.getpid()}")
    t0 = time.perf_counter()
    try:
        path, _ = build(directory=work)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    seconds = time.perf_counter() - t0
    # the port's one compile: the live plane's jit.compile_seconds
    from delphi_tpu_torch.observability import live
    live.observe_compile(seconds)
    if seconds >= compile_plane.min_compile_secs():
        os.replace(path, cached)
        os.rmdir(work)
        compile_plane.record_cache_dir_stats(directory)
        return cached, False
    return path, True


def library() -> ctypes.CDLL:
    """The loaded kernel library (resolved and loaded on first call; see
    :func:`_resolve_library`)."""
    global _lib
    with _lock:
        if _lib is None:
            path, private = _resolve_library()
            lib = ctypes.CDLL(path)
            if private:
                # an uncached build: the loaded library stays mapped
                os.remove(path)
                os.rmdir(os.path.dirname(path))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            # (table pointer, grid, shared bytes, stream)
            lib.delphi_pair_counts.restype = i32
            lib.delphi_pair_counts.argtypes = [vp, i32, i32, vp]
            # (table pointer, stream)
            lib.delphi_entropy_terms.restype = i32
            lib.delphi_entropy_terms.argtypes = [vp, vp]
            # (table pointer, grid x, grid y, shared bytes, stream)
            lib.delphi_domain_scores.restype = i32
            lib.delphi_domain_scores.argtypes = [vp, i32, i32, i32, vp]
            # (parameter table pointer, stream)
            for name in ("delphi_gbdt_hist", "delphi_gbdt_split",
                         "delphi_gbdt_route", "delphi_gbdt_predict",
                         "delphi_logreg_forward", "delphi_logreg_backward",
                         "delphi_adam_step"):
                getattr(lib, name).restype = i32
                getattr(lib, name).argtypes = [vp, vp]
            lib.delphi_launch_floor.restype = i32
            lib.delphi_launch_floor.argtypes = [vp]
            # (output pointer, chain length, addend, stream)
            lib.delphi_add_chain.restype = i32
            lib.delphi_add_chain.argtypes = [vp, i32, ctypes.c_float, vp]
            _lib = lib
        return _lib


def reset_library() -> None:
    """Forgets the loaded library, so that the next :func:`library`
    resolves it through the build cache again (and counts)."""
    global _lib
    with _lock:
        _lib = None


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{kernel}: CUDA launch failed (cudaError {err})")


def current_stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
