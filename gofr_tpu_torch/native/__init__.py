"""Native host components of the port (counterpart of
``gofr_tpu/native``): the byte-level BPE encoder, ``tokenizer.cpp``.

It is built at first use by one ``g++ -O2 -shared`` into
``build/gofr_tpu_torch/tokenizer-<hash>.so`` at the root of the checkout
(keyed by the source's and the flags' hash), never next to the source,
and loaded with ``ctypes``. As in the JAX package the toolchain is not
required: :func:`load_tokenizer_lib` returns None where no library can be
built or loaded, the tokenizer then encodes in Python, and
:func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gofr_tpu_torch"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_CACHE: dict = {}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"tokenizer-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile into ``out``; None on success, else why it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except FileNotFoundError:
        return "g++ not found"
    except subprocess.CalledProcessError as exc:
        return f"g++ failed: {exc.stderr.decode(errors='replace')[-400:]}"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"g++ failed: {exc!r}"
    os.replace(tmp, out)
    return None


def load_tokenizer_lib():
    """ctypes handle to the BPE library, or None (see :func:`build_error`)."""
    with _LOCK:
        if "lib" in _CACHE:
            return _CACHE["lib"]
        out = library_path()
        error = None if out.exists() else _build(out)
        lib = None
        if error is None:
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as exc:
                error = f"load failed: {exc}"
        if lib is not None:
            lib.gofr_tok_new.restype = ctypes.c_void_p
            lib.gofr_tok_new.argtypes = [ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int32]
            lib.gofr_tok_encode.restype = ctypes.c_int32
            lib.gofr_tok_encode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32]
            lib.gofr_tok_decode.restype = ctypes.c_int32
            lib.gofr_tok_decode.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32]
            lib.gofr_tok_free.argtypes = [ctypes.c_void_p]
        _CACHE["lib"] = lib
        _CACHE["error"] = error
        return lib


def build_error() -> Optional[str]:
    """Why the library is unavailable, after :func:`load_tokenizer_lib`;
    None when it loaded."""
    load_tokenizer_lib()
    return _CACHE["error"]
