"""Migrations example (counterpart of
``examples/using-migrations/main.py``): versioned schema set-up and a
seed over SQL and Redis, with CRUD routes on ``/employee`` on top.

Its ``.env`` holds JAX's defaults (sqlite ``:memory:``, in-process
Redis); the process environment wins over them. JAX's module writes
them into ``os.environ`` at import, where they reach every later app of
the process; the port's file does not. Run it with ``python -m
gofr_tpu_torch.examples.using_migrations``.
"""

from __future__ import annotations

import dataclasses

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.migration import Migration


def create_employee_table(ds):
    ds.sql.execute(
        "CREATE TABLE employee (id INTEGER PRIMARY KEY, name TEXT, "
        "department TEXT)")


def seed_employees(ds):
    ds.sql.execute("INSERT INTO employee VALUES (?, ?, ?)", 1, "ada",
                   "compute")
    ds.redis.set("employee:seeded", "true")


@dataclasses.dataclass
class Employee:
    id: int = 0
    name: str = ""
    department: str = ""


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_migrations"), device=device)
    app.migrate({
        1: Migration(up=create_employee_table),
        2: Migration(up=seed_employees),
    })
    app.add_rest_handlers(Employee)
    return app


if __name__ == "__main__":
    build_app().run()
