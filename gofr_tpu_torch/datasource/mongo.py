"""Mongo datasource (a copy of ``gofr_tpu/datasource/mongo.py``):
``InMemoryMongo``, an in-process engine with a Mongo-style filter subset
($eq by value, $gt/$gte/$lt/$lte/$ne/$in), the provider over ``pymongo``
(gated on the driver), and ``new_mongo``, which picks one from
``MONGO_URI``.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
from typing import Any, Dict, Iterable, List, Optional


class MongoError(Exception):
    pass


def _match(document: Dict[str, Any], filter_: Optional[Dict[str, Any]]) -> bool:
    if not filter_:
        return True
    for key, condition in filter_.items():
        value = document.get(key)
        if isinstance(condition, dict):
            for op, operand in condition.items():
                if op == "$gt" and not (value is not None and value > operand):
                    return False
                elif op == "$gte" and not (value is not None
                                           and value >= operand):
                    return False
                elif op == "$lt" and not (value is not None and value < operand):
                    return False
                elif op == "$lte" and not (value is not None
                                           and value <= operand):
                    return False
                elif op == "$ne" and not value != operand:
                    return False
                elif op == "$in" and value not in operand:
                    return False
                elif op not in ("$gt", "$gte", "$lt", "$lte", "$ne", "$in"):
                    raise MongoError(f"unsupported operator {op!r}")
        elif value != condition:
            return False
    return True


class _BaseMongo:
    def __init__(self, logger, metrics):
        self.logger = logger
        self.metrics = metrics

    def _observe(self, op: str, collection: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        self.metrics.record_histogram("app_sql_stats", elapsed,
                                      type=f"mongo.{op}")
        self.logger.debug("MONGO %s %s in %.2fms", op, collection,
                          elapsed * 1e3)


class InMemoryMongo(_BaseMongo):
    """Document store with Mongo CRUD semantics; auto _id sequence."""

    def __init__(self, logger, metrics):
        super().__init__(logger, metrics)
        self._collections: Dict[str, List[Dict[str, Any]]] = {}
        self._sequence = itertools.count(1)
        self._lock = threading.RLock()

    def _collection(self, name: str) -> List[Dict[str, Any]]:
        return self._collections.setdefault(name, [])

    def insert_one(self, collection: str, document: Dict[str, Any]) -> Any:
        start = time.perf_counter()
        with self._lock:
            doc = copy.deepcopy(document)
            doc.setdefault("_id", next(self._sequence))
            self._collection(collection).append(doc)
        self._observe("insert_one", collection, start)
        return doc["_id"]

    def insert_many(self, collection: str,
                    documents: Iterable[Dict[str, Any]]) -> List[Any]:
        return [self.insert_one(collection, d) for d in documents]

    def find(self, collection: str,
             filter_: Optional[Dict[str, Any]] = None,
             limit: int = 0) -> List[Dict[str, Any]]:
        start = time.perf_counter()
        with self._lock:
            out = [copy.deepcopy(d) for d in self._collection(collection)
                   if _match(d, filter_)]
        if limit:
            out = out[:limit]
        self._observe("find", collection, start)
        return out

    def find_one(self, collection: str,
                 filter_: Optional[Dict[str, Any]] = None
                 ) -> Optional[Dict[str, Any]]:
        rows = self.find(collection, filter_, limit=1)
        return rows[0] if rows else None

    def update_by_id(self, collection: str, doc_id: Any,
                     update: Dict[str, Any]) -> int:
        start = time.perf_counter()
        changes = update.get("$set", update)
        count = 0
        with self._lock:
            for document in self._collection(collection):
                if document.get("_id") == doc_id:
                    document.update(copy.deepcopy(changes))
                    count += 1
        self._observe("update_by_id", collection, start)
        return count

    def update_many(self, collection: str, filter_: Dict[str, Any],
                    update: Dict[str, Any]) -> int:
        changes = update.get("$set", update)
        count = 0
        with self._lock:
            for document in self._collection(collection):
                if _match(document, filter_):
                    document.update(copy.deepcopy(changes))
                    count += 1
        return count

    def delete_one(self, collection: str, filter_: Dict[str, Any]) -> int:
        with self._lock:
            docs = self._collection(collection)
            for i, document in enumerate(docs):
                if _match(document, filter_):
                    del docs[i]
                    return 1
        return 0

    def delete_many(self, collection: str, filter_: Dict[str, Any]) -> int:
        with self._lock:
            docs = self._collection(collection)
            keep = [d for d in docs if not _match(d, filter_)]
            removed = len(docs) - len(keep)
            self._collections[collection] = keep
        return removed

    def count_documents(self, collection: str,
                        filter_: Optional[Dict[str, Any]] = None) -> int:
        return len(self.find(collection, filter_))

    def drop_collection(self, collection: str) -> None:
        with self._lock:
            self._collections.pop(collection, None)

    def health_check(self) -> Dict[str, Any]:
        return {"status": "UP",
                "details": {"engine": "memory",
                            "collections": len(self._collections)}}

    def close(self) -> None:
        pass


class PyMongoClient(_BaseMongo):
    """Driver-backed implementation (gated on pymongo)."""

    def __init__(self, config, logger, metrics):
        super().__init__(logger, metrics)
        try:
            import pymongo
        except ImportError as exc:
            raise MongoError(
                "MONGO_URI configured but pymongo is not installed; use "
                "MONGO_URI=memory for the in-process engine") from exc
        uri = config.get("MONGO_URI")
        self._client = pymongo.MongoClient(uri,
                                           serverSelectionTimeoutMS=5000)
        self._db = self._client[config.get_or_default("MONGO_DATABASE",
                                                      "gofr")]
        logger.info("mongo connected %s", uri)

    def insert_one(self, collection, document):
        start = time.perf_counter()
        result = self._db[collection].insert_one(dict(document))
        self._observe("insert_one", collection, start)
        return result.inserted_id

    def insert_many(self, collection, documents):
        return list(self._db[collection].insert_many(
            [dict(d) for d in documents]).inserted_ids)

    def find(self, collection, filter_=None, limit=0):
        cursor = self._db[collection].find(filter_ or {})
        if limit:
            cursor = cursor.limit(limit)
        return list(cursor)

    def find_one(self, collection, filter_=None):
        return self._db[collection].find_one(filter_ or {})

    def update_by_id(self, collection, doc_id, update):
        if "$set" not in update:
            update = {"$set": update}
        return self._db[collection].update_one(
            {"_id": doc_id}, update).modified_count

    def update_many(self, collection, filter_, update):
        if "$set" not in update:
            update = {"$set": update}
        return self._db[collection].update_many(filter_,
                                                update).modified_count

    def delete_one(self, collection, filter_):
        return self._db[collection].delete_one(filter_).deleted_count

    def delete_many(self, collection, filter_):
        return self._db[collection].delete_many(filter_).deleted_count

    def count_documents(self, collection, filter_=None):
        return self._db[collection].count_documents(filter_ or {})

    def drop_collection(self, collection):
        self._db[collection].drop()

    def health_check(self):
        try:
            self._client.admin.command("ping")
            return {"status": "UP", "details": {"engine": "pymongo"}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self):
        self._client.close()


def new_mongo(config, logger, metrics):
    uri = config.get_or_default("MONGO_URI", "memory")
    if uri in ("memory", ":memory:", ""):
        return InMemoryMongo(logger, metrics)
    return PyMongoClient(config, logger, metrics)
