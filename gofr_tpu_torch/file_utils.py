"""Archive helpers for upload handling (counterpart of
``gofr_tpu/file_utils.py``): zip expansion with a 100 MB
decompression-bomb guard, used by the multipart examples.

A member whose header understates its size is refused by ``zipfile``
itself: it stops at the declared size and fails the CRC check with
``zipfile.BadZipFile``, as it does under the JAX package.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Dict

MAX_UNZIP_BYTES = 100 * 1024 * 1024


class ZipBombError(Exception):
    pass


def unzip_bytes(data: bytes,
                max_bytes: int = MAX_UNZIP_BYTES) -> Dict[str, bytes]:
    """Expand a zip archive held in memory → {name: content}. Refuses
    archives whose declared or actual expansion exceeds ``max_bytes``,
    and member names that leave the archive's root."""
    out: Dict[str, bytes] = {}
    total = 0
    with zipfile.ZipFile(io.BytesIO(data)) as archive:
        declared = sum(info.file_size for info in archive.infolist())
        if declared > max_bytes:
            raise ZipBombError(
                f"archive declares {declared} bytes > limit {max_bytes}")
        for info in archive.infolist():
            if info.is_dir():
                continue
            name = info.filename
            if name.startswith("/") or ".." in name.split("/"):
                raise ZipBombError(f"unsafe member path {name!r}")
            content = archive.read(info)
            total += len(content)
            if total > max_bytes:
                raise ZipBombError(f"expansion exceeded limit {max_bytes}")
            out[name] = content
    return out


def unzip_to_dir(data: bytes, directory: str,
                 max_bytes: int = MAX_UNZIP_BYTES) -> int:
    """Expand to disk under ``directory``; returns the file count."""
    files = unzip_bytes(data, max_bytes)
    for name, content in files.items():
        path = os.path.join(directory, name)
        os.makedirs(os.path.dirname(path) or directory, exist_ok=True)
        with open(path, "wb") as handle:
            handle.write(content)
    return len(files)
