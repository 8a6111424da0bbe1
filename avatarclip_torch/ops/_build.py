"""Build the native sources under ``csrc/`` at first use and load them with ctypes.

Each CUDA library is compiled by ``nvcc`` for ``sm_90a`` into
``avatarclip_torch/build/lib{name}_{hash}.so``; the hash covers the sources,
every header under ``csrc/`` and the flags, so an edited source is rebuilt
and an unchanged one is reused. ``ptxas -v`` output (registers, shared
memory, spills) goes to ``build/{name}.log``. :func:`load_all` starts one
``nvcc`` per library at once and waits for all of them. Host-only C++
(``csrc/host/``) is built the same way with ``g++``. Nothing here runs at
import: CPU-only hosts import the kernel modules without ``nvcc``.
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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
_lock = threading.Lock()  # the validation worker thread may load a library too


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a host with the CUDA toolkit")
    return path


def _so_path(name: str, flags: list[str], sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build(jobs: list[tuple[str, list[str], Path]]) -> None:
    """Run the compile commands of ``jobs`` (name, argv, output) at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, argv, so in jobs:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            argv + ["-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, err = proc.communicate()
        (BUILD / f"{name}.log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err[-4000:]}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))


def load_all(pairs: list[tuple[str, str]]) -> dict[str, ctypes.CDLL]:
    """Compile each ``(name, csrc/{source})`` CUDA library that is not built
    yet, all in parallel, and load them."""
    with _lock:
        return _load_all(pairs)


def _load_all(pairs, defines: tuple[str, ...] = ()):
    headers = sorted(CSRC.glob("*.cu*"))
    flags = FLAGS + [f"-D{d}" for d in defines]
    jobs, paths = [], {}
    for name, source in pairs:
        if name in _loaded:
            continue
        so = _so_path(name, flags, headers)
        paths[name] = so
        if not so.exists():
            jobs.append((name, [_nvcc(), *flags, "-I", str(CSRC), str(CSRC / source)], so))
    if jobs:
        _build(jobs)
    for name, so in paths.items():
        _loaded[name] = ctypes.CDLL(str(so))
    return {name: _loaded[name] for name, _ in pairs}


def load(name: str, source: str) -> ctypes.CDLL:
    """Compile ``csrc/{source}`` (once per content hash) and load it."""
    lib = _loaded.get(name)  # the launch path: no lock, no file system
    return lib if lib is not None else load_all([(name, source)])[name]


def load_variant(name: str, source: str, defines: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``csrc/{source}`` with the macros ``defines`` set (a build of
    its own, e.g. the profiling one) and load it as ``name``."""
    with _lock:
        return _load_all([(name, source)], defines)[name]


def load_host(name: str, source: str) -> ctypes.CDLL:
    """Compile ``csrc/host/{source}`` with g++ (once per content hash) and load it."""
    with _lock:
        if name not in _loaded:
            src = CSRC / "host" / source
            so = _so_path(name, HOST_FLAGS, [src])
            if not so.exists():
                _build([(name, ["g++", *HOST_FLAGS, str(src)], so)])
            _loaded[name] = ctypes.CDLL(str(so))
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_f32(device, items) -> None:
    """Raise unless each (name, tensor, shape) is a contiguous float32 tensor
    of that shape on ``device``."""
    import torch

    for name, t, shape in items:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 {shape}")
        if t.device != device:
            raise ValueError(f"{name} is on another device")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
