"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` into
``avatarclip_torch/build/lib{name}_{hash}.so``; the hash covers the sources,
every header under ``csrc/`` and the flags, so an edited source is rebuilt
and an unchanged one is reused. ``ptxas -v`` output (registers, shared
memory, spills) goes to ``build/{name}.log``. Nothing here runs at import:
CPU-only hosts import the kernel modules without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")
    return path


def load(name: str, source: str) -> ctypes.CDLL:
    """Compile ``csrc/{source}`` (once per content hash) and load it."""
    if name in _loaded:
        return _loaded[name]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / source)],
            capture_output=True, text=True,
        )
        (BUILD / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
