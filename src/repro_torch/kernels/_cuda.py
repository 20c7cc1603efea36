"""Build and bind the port's hand-written CUDA kernels, shared by every
kernel family (``paged_decode``, ``flash_attention``, ``fused_optim``,
``gla``).

Each family registers its sources with :func:`register`. A source is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface and loaded with ``ctypes``: pointers and the current stream go in
as ``c_void_p``, and each C function returns ``cudaGetLastError()`` after
its launches, which :func:`launch` turns into an exception. The build
happens at first use, into ``kernels/_build/`` (git-ignored), under a name
carrying the hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: the kernel families, each of whose ``kernel`` module registers its sources
FAMILIES = ("paged_decode", "flash_attention", "fused_optim", "gla")
#: library name -> source file
SOURCES: Dict[str, Path] = {}
#: library name -> {C function: ctypes argtypes, the trailing stream excluded}
_SIGNATURES: Dict[str, Dict[str, List]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas reports (registers, shared memory, spills) of the builds this process ran
BUILD_LOGS: Dict[str, str] = {}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def register(name: str, source: Path, signatures: Dict[str, List]) -> None:
    """Declare library ``name``, built from ``source``, with its C functions
    and their argument types (each also takes the stream, last)."""
    SOURCES[name] = source
    _SIGNATURES[name] = {fn: list(args) + [P] for fn, args in signatures.items()}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: those of every family) that are
    not built yet, one ``nvcc`` per source, all started together. Returns
    the seconds each build took (0.0 for a library already on disk)."""
    if names is None:
        for family in FAMILIES:
            importlib.import_module(f"repro_torch.kernels.{family}.kernel")
        names = list(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        todo[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in todo.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {SOURCES[name].name}:\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(cond: bool, msg) -> None:
    """Raise ValueError(msg) unless ``cond``; ``msg`` may be a function that
    makes the message, so that a launch path formats none when all is well."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def check_cuda(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        check(t.is_cuda and t.device == device, lambda: f"{name} must be on {device}, got {t.device}")
        check(t.is_contiguous(), lambda: f"{name} must be contiguous")


def launch(lib: str, fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of ``lib`` on ``device``'s current stream; raise if a
    launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(_lib(lib), fn)(*args, stream)
    if code != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {code}")
