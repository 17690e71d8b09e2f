"""Local file-system datasource with typed row readers (a copy of
``gofr_tpu/datasource/file.py``): ``LocalFileSystem``, confined to its
root unless built with ``sandbox=False``, and JSON, JSON-lines, CSV and
text row readers chosen by extension.
"""

from __future__ import annotations

import csv
import io
import json
import os
import shutil
from typing import Iterator, List, Optional

from gofr_tpu_torch.datasource import UP, health


class LocalFileSystem:
    """Local filesystem datasource (datasource/file.go contract).

    ``sandbox=True`` (default) confines every operation — including
    ``chdir`` and absolute paths — under the constructed root, so request
    data forwarded into fs calls cannot traverse out (``../`` or
    ``/etc/...`` raise PermissionError). Construct with ``sandbox=False``
    for trusted tooling that genuinely needs the whole host filesystem
    (the reference's Go file datasource mirrors os with no confinement).
    """

    def __init__(self, logger=None, root: str = ".", sandbox: bool = True):
        self.logger = logger
        self.root = os.path.abspath(root)
        self.sandbox = sandbox
        # realpath: the confinement check must compare symlink-resolved
        # paths, or a pre-existing symlink under root pointing outside it
        # would pass a plain prefix test
        self._sandbox_root = os.path.realpath(self.root)

    def _full(self, name: str) -> str:
        base = name if os.path.isabs(name) else os.path.join(self.root, name)
        full = os.path.abspath(base)
        if self.sandbox:
            root = self._sandbox_root
            # resolve symlinks on the deepest existing ancestor so both
            # existing targets and to-be-created paths are checked against
            # where they will REALLY land
            resolved = os.path.realpath(full)
            if resolved != root and not resolved.startswith(root + os.sep):
                raise PermissionError(
                    f"path escapes filesystem root {root!r}: {name!r}")
        return full

    # -- FileSystem contract (datasource/file.go:10-63) ---------------------
    def create(self, name: str, content: bytes = b"") -> None:
        with open(self._full(name), "wb") as fh:
            fh.write(content)

    def read(self, name: str) -> bytes:
        with open(self._full(name), "rb") as fh:
            return fh.read()

    def write(self, name: str, content: bytes) -> None:
        self.create(name, content)

    def append(self, name: str, content: bytes) -> None:
        with open(self._full(name), "ab") as fh:
            fh.write(content)

    def remove(self, name: str) -> None:
        os.remove(self._full(name))

    def mkdir(self, name: str) -> None:
        os.makedirs(self._full(name), exist_ok=True)

    def remove_all(self, name: str) -> None:
        shutil.rmtree(self._full(name), ignore_errors=True)

    def rename(self, old: str, new: str) -> None:
        os.rename(self._full(old), self._full(new))

    def stat(self, name: str) -> dict:
        st = os.stat(self._full(name))
        return {"size": st.st_size, "mtime": st.st_mtime,
                "is_dir": os.path.isdir(self._full(name))}

    def list(self, name: str = ".") -> List[str]:
        return sorted(os.listdir(self._full(name)))

    def getwd(self) -> str:
        return os.path.abspath(self.root)

    def chdir(self, name: str) -> None:
        self.root = self._full(name)

    # -- typed row reading (datasource/file.go:51-141) ----------------------
    def read_all(self, name: str) -> "RowReader":
        ext = os.path.splitext(name)[1].lower()
        raw = self.read(name)
        if ext == ".json":
            return JSONRowReader(raw)
        if ext == ".jsonl":
            return JSONLRowReader(raw)
        if ext == ".csv":
            return CSVRowReader(raw)
        return TextRowReader(raw)

    def health_check(self) -> dict:
        return health(UP, root=self.getwd())


class RowReader:
    def __iter__(self) -> Iterator:
        raise NotImplementedError


class JSONRowReader(RowReader):
    def __init__(self, raw: bytes):
        doc = json.loads(raw.decode("utf-8"))
        self.rows = doc if isinstance(doc, list) else [doc]

    def __iter__(self):
        return iter(self.rows)


class JSONLRowReader(RowReader):
    """One JSON document per line — the LLM-dataset interchange format."""

    def __init__(self, raw: bytes):
        self.rows = []
        for number, line in enumerate(raw.decode("utf-8").splitlines(), 1):
            if not line.strip():
                continue
            try:
                self.rows.append(json.loads(line))
            except json.JSONDecodeError as exc:
                raise ValueError(f"jsonl line {number}: {exc}") from exc

    def __iter__(self):
        return iter(self.rows)


class CSVRowReader(RowReader):
    def __init__(self, raw: bytes):
        self.reader = csv.DictReader(io.StringIO(raw.decode("utf-8")))

    def __iter__(self):
        return iter(self.reader)


class TextRowReader(RowReader):
    def __init__(self, raw: bytes):
        self.lines = raw.decode("utf-8", "replace").splitlines()

    def __iter__(self):
        return iter(self.lines)
