"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/torch_ext/`` at the repository root (listed in ``.gitignore``).
The library's file name carries a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when the package is imported: the first launch of a
kernel builds and loads it, and ``build()`` builds several at once, one
``nvcc`` process per source, all started together.

A failed build raises with nvcc's stderr; a failed launch raises with
the CUDA error (see ``check``).  Nothing falls back to another path.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# argtypes of each library's C entry point
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ENTRY_POINTS = {
    "paged_attention": ("paged_attention_launch",
                        [_P] * 9 + [_I] * 11 + [_F, _P]),
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I] * 3 + [_F, _P]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_P] * 13 + [_I] * 5 + [_L] * 15 + [_I] * 4 + [_F, _P]),
    "mamba_scan": ("mamba1_scan_launch",
                   [_P] * 10 + [_I] * 5 + [_L] * 8 + [_I, _P]),
    "mixed_gemm": ("mixed_gemm_launch",
                   [_P, _L, _P, _P, _P, _L, _L, _P, _P, _L] + [_P] * 3 + [_I] * 7 + [_P]),
}

_ARG_ERRORS = {-1: "unsupported dtype combination", -2: "unsupported head_dim",
               -3: "unsupported head grouping", -4: "empty or invalid shape",
               -5: "unsupported state size",
               -6: "TMA descriptor refused: base address and strides must be "
                   "multiples of 16 bytes"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}       # guarded-by: _lock


class LaunchCounter:
    """Kernel launches since the last ``reset``; the serving threads all
    launch kernels, so the count is taken under a lock.  Inside ``held``
    a thread's calls are tallied apart instead (a CUDA graph's capture:
    they launch at each replay, which its owner counts)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0                       # guarded-by: _lock
        self._local = threading.local()   # .tally: this thread's held count

    def add(self, n: int = 1) -> None:
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[0] += n
            return
        with self._lock:
            self._n += n

    @contextlib.contextmanager
    def held(self):
        """Tally this thread's ``add`` calls in the block apart from the
        count; yields the tally, a one-item list."""
        outer = getattr(self._local, "tally", None)
        self._local.tally = tally = [0]
        try:
            yield tally
        finally:
            self._local.tally = outer

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels cannot be built")
    return str(path)


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns {name: {"seconds", "log", "cached"}} where ``log`` is nvcc's
    output (register and shared-memory use per kernel).  Raises
    RuntimeError with nvcc's stderr if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result: Dict[str, Dict[str, object]] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            result[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                            f"{stderr}{stdout}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)              # atomic: concurrent builders agree
        result[name] = {"seconds": time.perf_counter() - t0,
                        "log": stderr + stdout, "cached": False}
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fn_name, argtypes = ENTRY_POINTS[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero return code of a kernel's C entry point."""
    if rc == 0:
        return
    if rc < 0:
        raise ValueError(f"{name}: {_ARG_ERRORS.get(rc, f'argument error {rc}')}")
    with _lock:
        lib = _libs[name]
    text = lib.repro_cuda_error_string(rc)
    raise RuntimeError(f"{name}: kernel launch failed: cudaError_t {rc} "
                       f"({text.decode() if text else 'unknown'})")
