"""CRUD scaffolding: one dataclass → five REST routes (counterpart of
``gofr_tpu/crud.py``).

The first field of the dataclass is the primary key. A ``table_name``
or ``rest_path`` callable on the class overrides the snake-cased class
name. The routes run on the container's SQL through the query builder.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Type

from gofr_tpu_torch.datasource.sql.query_builder import (
    delete_by_query,
    insert_query,
    select_all_query,
    select_by_query,
    update_by_query,
)
from gofr_tpu_torch.http.errors import EntityNotFound, InvalidParam


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


class EntityMeta:
    def __init__(self, entity_class: Type):
        if not dataclasses.is_dataclass(entity_class):
            raise TypeError(
                f"add_rest_handlers needs a dataclass, got {entity_class}")
        self.entity_class = entity_class
        self.fields = [f.name for f in dataclasses.fields(entity_class)]
        self.primary_key = self.fields[0]
        table_override = getattr(entity_class, "table_name", None)
        self.table = table_override() if callable(table_override) \
            else _snake(entity_class.__name__)
        path_override = getattr(entity_class, "rest_path", None)
        self.path = "/" + (path_override() if callable(path_override)
                           else _snake(entity_class.__name__))


def register_crud_routes(app, entity_class: Type) -> None:
    meta = EntityMeta(entity_class)
    name = entity_class.__name__

    def _dialect(ctx) -> str:
        return ctx.sql.dialect

    def create(ctx):
        entity = ctx.bind(meta.entity_class)
        values = [getattr(entity, f) for f in meta.fields]
        ctx.sql.execute(insert_query(_dialect(ctx), meta.table, meta.fields),
                        *values)
        pk_value = getattr(entity, meta.primary_key)
        return f"{name} successfully created with id: {pk_value}"

    def get_all(ctx):
        return ctx.sql.bind(meta.entity_class,
                            select_all_query(_dialect(ctx), meta.table))

    def get_one(ctx):
        entity_id = ctx.path_param("id")
        rows = ctx.sql.bind(
            meta.entity_class,
            select_by_query(_dialect(ctx), meta.table, meta.primary_key),
            entity_id)
        if not rows:
            raise EntityNotFound("id", str(entity_id))
        return rows[0]

    def update(ctx):
        entity_id = ctx.path_param("id")
        entity = ctx.bind(meta.entity_class)
        columns = meta.fields[1:]  # the primary key does not change
        if not columns:
            raise InvalidParam([meta.primary_key])
        values = [getattr(entity, f) for f in columns]
        changed = ctx.sql.execute(
            update_by_query(_dialect(ctx), meta.table, columns,
                            meta.primary_key),
            *values, entity_id)
        if changed == 0:
            raise EntityNotFound("id", str(entity_id))
        return f"{name} successfully updated with id: {entity_id}"

    def delete(ctx):
        entity_id = ctx.path_param("id")
        changed = ctx.sql.execute(
            delete_by_query(_dialect(ctx), meta.table, meta.primary_key),
            entity_id)
        if changed == 0:
            raise EntityNotFound("id", str(entity_id))
        return f"{name} successfully deleted with id: {entity_id}"

    app.post(meta.path, create)
    app.get(meta.path, get_all)
    app.get(meta.path + "/{id}", get_one)
    app.put(meta.path + "/{id}", update)
    app.delete(meta.path + "/{id}", delete)
