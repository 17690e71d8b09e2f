"""Build and load the port's CUDA kernels (counterpart of
``gofr_tpu/ops/pallas/fallback.py``, which held the JAX package's kernel
dispatch policy).

Each ``gofr_tpu_torch/csrc/<name>.cu`` is compiled at first use by one
``nvcc`` process into its own shared library with a plain C interface,
``build/gofr_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags, and loaded with ``ctypes``.
:func:`build_all` starts one ``nvcc`` per source, all together.
Nothing is built when a module is imported.

Kernel choice is by device alone: a wrapper given CPU tensors runs the
plain PyTorch version; given CUDA tensors it launches the kernel or
raises. There is no shape-based fallback and no ``try`` that falls back.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gofr_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC"]
KERNELS = ("flash_attention", "ragged_paged_attention", "decode_attention")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "gofr_tpu_torch: nvcc not found (PATH or $CUDA_HOME/bin); the "
        "CUDA kernels cannot be built")


def _sources(name: str) -> list:
    return [CSRC / f"{name}.cu"]


def library_path(name: str) -> Path:
    """Build output for kernel ``name``: keyed by the sources' and the
    flags' hash, so an edited source never loads a stale library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str, nvcc: str) -> Optional[Tuple]:
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (process, output path, temporary path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources(name)]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish_build(name: str, started: Optional[Tuple]) -> None:
    if started is None:
        return
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"gofr_tpu_torch: nvcc failed for {name} "
            f"(exit {proc.returncode}):\n{log}")
    # atomic publish: a concurrent builder of the same hash loses nothing
    os.replace(tmp, out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel not yet built, one ``nvcc`` per source,
    all started together; raises on the first failure after all end."""
    names = list(names)
    nvcc = find_nvcc()
    with _lock:
        procs = {name: _start_build(name, nvcc) for name in names}
        errors = []
        for name, proc in procs.items():
            try:
                _finish_build(name, proc)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    Raises RuntimeError without CUDA or ``nvcc``, or when the build
    fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"gofr_tpu_torch: kernel {name} needs a CUDA device")
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
