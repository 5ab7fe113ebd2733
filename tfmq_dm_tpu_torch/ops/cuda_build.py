"""Build and load the port's CUDA sources (``csrc/*.cu``).

Each source is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface under ``_build/`` (named by
the content hash of the source and the ``csrc/*.cuh`` headers it may
include, so an edited source or header rebuilds) and loaded with
``ctypes``. Nothing is compiled when a module is imported: a library is
built at its first use, or when ``load(force=True)`` asks for a cold build.
Two sources build independently, so callers may build them in parallel
(each build is one ``nvcc`` process).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return path


class CudaLibrary:
    """One ``csrc`` source, compiled once per content and bound by
    ``bind(lib)`` (which sets ``argtypes``/``restype``). ``log`` holds the
    last cold build's seconds and ``ptxas`` report."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.bind = bind
        self.log = {"seconds": None, "ptxas": ""}
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self, force: bool = False) -> ctypes.CDLL:
        """Compile (if needed) and load. ``force`` deletes this source's
        built libraries first, for a cold build."""
        with self._lock:
            stem = self.source.stem
            if force:
                self._lib = None
                for old in BUILD_DIR.glob(f"{stem}_*.so"):
                    old.unlink()
            if self._lib is not None:
                return self._lib
            # the source and the headers beside it (csrc/*.cuh)
            h = hashlib.sha256(self.source.read_bytes())
            for header in sorted(self.source.parent.glob("*.cuh")):
                h.update(header.read_bytes())
            digest = h.hexdigest()
            so = BUILD_DIR / f"{stem}_{digest[:16]}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(self.source)]
                t0 = time.perf_counter()
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                       f"{' '.join(cmd)}\n{res.stderr}")
                os.replace(tmp, so)
                self.log["seconds"] = time.perf_counter() - t0
                self.log["ptxas"] = res.stderr
            lib = ctypes.CDLL(str(so))
            self.bind(lib)
            self._lib = lib
            return lib


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def launch_check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
