"""CRUD scaffolding example (counterpart of
``examples/using-add-rest-handlers/main.py``): one dataclass registers
five REST routes (``POST``, ``GET`` all, ``GET``, ``PUT`` and ``DELETE``
on ``/user``) over the configured SQL datasource (sqlite ``:memory:`` in
its ``.env``); a migration creates the table at build.

Run it with ``python -m gofr_tpu_torch.examples.using_add_rest_handlers``.
"""

from __future__ import annotations

import dataclasses

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.migration import Migration


@dataclasses.dataclass
class User:
    id: int = 0
    name: str = ""
    age: int = 0
    is_employed: bool = False


def create_table(ds):
    ds.sql.execute(
        "CREATE TABLE IF NOT EXISTS user ("
        "id INTEGER PRIMARY KEY, name TEXT, age INTEGER, "
        "is_employed BOOLEAN)")


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_add_rest_handlers"), device=device)
    app.migrate({1: Migration(up=create_table)})
    app.add_rest_handlers(User)
    return app


if __name__ == "__main__":
    build_app().run()
