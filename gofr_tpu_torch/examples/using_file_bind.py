"""File-bind example (counterpart of ``examples/using-file-bind/main.py``):
``POST /upload`` takes a multipart form with a text field (``name``) and
a file (``upload``) and reports the file's size; a ``.zip`` is expanded
under the zip-bomb guard of ``gofr_tpu_torch.file_utils`` and its
members listed. A form with no file part is a 400.

Run it with ``python -m gofr_tpu_torch.examples.using_file_bind``.
"""

from __future__ import annotations

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.file_utils import unzip_bytes
from gofr_tpu_torch.http.errors import InvalidParam
from gofr_tpu_torch.http.request import UploadedFile


async def upload(ctx):
    form = ctx.bind()
    blob = form.get("upload")
    if not isinstance(blob, UploadedFile):
        raise InvalidParam(["upload"])
    info = {"name": form.get("name", ""),
            "filename": blob.filename,
            "bytes": len(blob.content)}
    if blob.filename.endswith(".zip"):
        info["zip_members"] = sorted(unzip_bytes(blob.content))
    return info


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_file_bind"), device=device)
    app.post("/upload", upload)
    return app


if __name__ == "__main__":
    build_app().run()
