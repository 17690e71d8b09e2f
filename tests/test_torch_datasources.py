"""The port's datasources against the JAX package's, on the CPU: the
context's accessors and a subscriber's message, SQL on sqlite
``:memory:``, the query builders, Redis (the RESP2 client over
``FakeRESPServer``, ``InMemoryRedis`` under a controlled clock),
migrations through ``App.migrate``, Mongo, Cassandra and ClickHouse (the
engines, the mocks, the gated providers over the stub drivers), the
remote log level, and the container that wires them. Each case drives
both packages through the same inputs and compares what comes out."""

import asyncio
import dataclasses
import importlib
import json
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from tests.test_gated_drivers import (_FakeCHClient, _FakeCluster,
                                      _FakeMongoClient, _module)
from tests.test_wire_fuzz import (FakeRESPServer, RedisServerError,
                                  _rand_reply)

PKGS = {"jax": "gofr_tpu", "port": "gofr_tpu_torch"}
SIDES = ("jax", "port")


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def mock(side, config=None):
    new = mod(side, "container").new_mock_container
    return new(config) if side == "jax" else new(config, device="cpu")


def config(side, values):
    return mod(side, "config").MapConfig(values)


def silent(side):
    return mod(side, "logging").new_silent_logger()


def series(metrics, name):
    """A metric's label sets with their counts (histograms) or values."""
    return {key: value["count"] if isinstance(value, dict) else value
            for key, value in metrics.snapshot()[name].series.items()}


@dataclasses.dataclass
class Order:
    id: int
    item: str


# -- the two repaired faults ---------------------------------------------------

def test_context_datasource_accessors_are_none_without_config():
    got = {}
    for side in SIDES:
        container = mod(side, "container").Container(
            config=config(side, {}), logger=silent(side))
        ctx = mod(side, "context").Context(None, container)
        got[side] = [getattr(ctx, name) for name in
                     ("sql", "redis", "mongo", "cassandra", "clickhouse")]
    assert got["port"] == got["jax"] == [None] * 5


def test_subscriber_binds_its_message_and_commits_as_jax():
    payloads = [b'{"id": 7, "item": "tea"}', b"42", b"plain text"]
    got = {}
    for side in SIDES:
        app = mod(side, "app").App(config=config(side, {}),
                                   container=mock(side))
        seen = []

        def handler(ctx):
            seen.append((ctx.param("topic"), ctx.path_param("topic"),
                         ctx.param("missing"), ctx.bind(),
                         ctx.request.to_log(), ctx.request))
            if ctx.request.value.startswith(b"{"):
                seen.append(("bound", ctx.bind(Order), ctx.bind(dict)))
            elif ctx.request.value == b"42":
                seen.append(("scalar", ctx.bind(int), ctx.bind(float),
                             ctx.bind(str)))

        async def main():
            broker = app.container.pubsub
            task = asyncio.ensure_future(app._subscriber_loop("orders",
                                                              handler))
            for payload in payloads:
                broker.publish("orders", payload)
            for _ in range(200):
                if sum(1 for s in seen if s[0] == "orders") == 3:
                    break
                await asyncio.sleep(0.005)
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

        asyncio.run(main())
        messages = [s[-1] for s in seen if s[0] == "orders"]
        got[side] = ([s[:-1] if s[0] == "orders" else s for s in seen],
                     [m.committed for m in messages])
    assert got["port"] == got["jax"]
    assert got["port"][1] == [True] * 3
    assert ("bound", Order(7, "tea"), {"id": 7, "item": "tea"}) \
        in got["port"][0]


# -- SQL ---------------------------------------------------------------------------

def test_sql_rows_dataclasses_and_transactions_as_jax():
    got = {}
    for side in SIDES:
        container = mock(side)
        db = container.sql
        out = [db.execute("CREATE TABLE orders (id INTEGER PRIMARY KEY, "
                          "item TEXT)")]
        rng = random.Random(23)
        for i in range(20):
            out.append(db.execute("INSERT INTO orders (id, item) VALUES "
                                  "(?, ?)", i, f"item-{rng.randint(0, 99)}"))
        out.append(db.select("SELECT * FROM orders WHERE id < ?", 5))
        out.append(db.query_row("SELECT item FROM orders WHERE id = ?", 3))
        out.append(db.query_row("SELECT item FROM orders WHERE id = ?", 99))
        out.append(db.bind(Order, "SELECT * FROM orders ORDER BY id DESC "
                                  "LIMIT 3"))
        tx = db.begin()
        tx.execute("DELETE FROM orders WHERE id < 10")
        tx.rollback()
        with db.begin() as tx:
            tx.execute("UPDATE orders SET item = ? WHERE id = ?", "x", 1)
        out.append(db.select("SELECT COUNT(*) AS n FROM orders"))
        out.append(db.select("SELECT item FROM orders WHERE id = 1"))
        with pytest.raises(mod(side, "datasource.sql").SQLError):
            db.select("SELECT * FROM missing")
        health = db.health_check()
        out.append((health["status"], sorted(health["details"])))
        out.append(sorted(series(container.metrics, "app_sql_stats")
                          .values()) != [])
        db.close()
        got[side] = out
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("dialect", ["sqlite", "mysql", "postgres"])
def test_query_builders_as_jax(dialect):
    got = {}
    for side in SIDES:
        qb = mod(side, "datasource.sql")
        got[side] = [
            qb.insert_query(dialect, "t", ["a", "b", "c"]),
            qb.select_all_query(dialect, "t"),
            qb.select_by_query(dialect, "t", "id"),
            qb.update_by_query(dialect, "t", ["a", "b"], "id"),
            qb.delete_by_query(dialect, "t", "id")]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("dialect", ["mysql", "postgres"])
def test_sql_server_dialects_without_driver_raise_as_jax(dialect):
    got = {}
    for side in SIDES:
        container = mock(side)
        with pytest.raises(mod(side, "datasource.sql").SQLError) as err:
            mod(side, "datasource.sql").new_sql(
                config(side, {"DB_DIALECT": dialect, "DB_HOST": "127.0.0.1"}),
                container.logger, container.metrics)
        got[side] = str(err.value)
    assert got["port"] == got["jax"]


# -- Redis -------------------------------------------------------------------------

def test_resp_commands_and_replies_as_jax():
    """Command bytes on the wire and decoded reply trees, seeded."""
    rng = random.Random(7)
    replies = [_rand_reply(rng) for _ in range(30)]
    replies += [RedisServerError("ERR boom"), 5]
    got = {}
    for side in SIDES:
        server = FakeRESPServer()
        server.replies = list(replies)
        container = mock(side)
        client = mod(side, "datasource.redisx").RedisClient(
            config(side, {"REDIS_HOST": "127.0.0.1",
                          "REDIS_PORT": str(server.port)}),
            container.logger, container.metrics)
        out = []
        try:
            for i in range(30):
                out.append(client.command("SET", f"k{i}\r\n", "значение", i))
            with pytest.raises(mod(side, "datasource.redisx").RedisError):
                client.command("INCR", "k")
            out.append(client.incr("k"))
        finally:
            client.close()
            server.close()
        got[side] = (out, server.received,
                     series(container.metrics, "app_redis_stats"))
    assert got["port"] == got["jax"]


class Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now


def redis_program(seed, n=300):
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(6)] + ["user:1", "user:2"]
    ops = []
    for _ in range(n):
        key = rng.choice(keys)
        op = rng.choice(["get", "set", "set_ttl", "delete", "exists",
                         "incr", "decr", "expire", "ttl", "keys", "hset",
                         "hget", "hgetall", "hsetnx", "lpush", "rpush",
                         "lpop", "rpop", "llen", "tick"])
        ops.append((op, key, rng.randint(0, 9), rng.uniform(0.0, 3.0)))
    return ops


def run_redis_program(redis, clock, ops):
    out = []
    for op, key, n, seconds in ops:
        try:
            if op == "tick":
                clock.now += seconds
                out.append(None)
            elif op == "set":
                out.append(redis.set(key, str(n)))
            elif op == "set_ttl":
                out.append(redis.set(key, str(n), ttl_seconds=seconds))
            elif op == "expire":
                out.append(redis.expire(key, seconds))
            elif op in ("hset", "hsetnx"):
                out.append(getattr(redis, op)(key, f"f{n % 3}", str(n)))
            elif op == "hget":
                out.append(redis.hget(key, f"f{n % 3}"))
            elif op in ("lpush", "rpush"):
                out.append(getattr(redis, op)(key, str(n), str(n + 1)))
            elif op == "keys":
                out.append(sorted(redis.keys("user:*" if n % 2 else "*")))
            else:
                out.append(getattr(redis, op)(key))
        except Exception as exc:                          # noqa: BLE001
            out.append(("raised", type(exc).__name__, str(exc)))
    return out


def test_inmemory_redis_seeded_program_as_jax(monkeypatch):
    ops = redis_program(31)
    got = {}
    for side in SIDES:
        client_mod = mod(side, "datasource.redisx.client")
        clock = Clock()
        monkeypatch.setattr(client_mod, "time", clock)
        container = mock(side)
        redis = container.redis
        out = run_redis_program(redis, clock, ops)
        out.append(redis.pipeline([("SET", "p", "1"), ("GET", "p"),
                                   ("INCR", "p"), ("HGET", "p", "f"),
                                   ("FLUSHDB",), ("GET", "p")]))
        out[-1] = [repr(r) if isinstance(r, Exception) else r
                   for r in out[-1]]
        health = redis.health_check()
        out.append(health)
        out.append(series(container.metrics, "app_redis_stats"))
        got[side] = out
    assert got["port"] == got["jax"]
    assert ("raised", "RedisError", "WRONGTYPE") in got["port"]


def test_new_redis_engines_as_jax():
    got = {}
    for side in SIDES:
        container = mock(side)
        redisx = mod(side, "datasource.redisx")
        memory = redisx.new_redis(config(side, {"REDIS_HOST": "memory"}),
                                  container.logger, container.metrics)
        with pytest.raises(OSError) as err:
            redisx.new_redis(config(side, {"REDIS_HOST": "127.0.0.1",
                                           "REDIS_PORT": "1"}),
                             container.logger, container.metrics)
        got[side] = (type(memory).__name__, type(err.value).__name__)
    assert got["port"] == got["jax"] == ("InMemoryRedis",
                                         "ConnectionRefusedError")


# -- migrations --------------------------------------------------------------------

def migrations_for(side, order):
    Migration = mod(side, "migration").Migration

    def make(tag, step):
        def up(ds):
            order.append(tag)
            step(ds)
        return Migration(up=up)

    return {
        3: make("third", lambda ds: ds.redis.set("config:v", "3")),
        1: make("first", lambda ds: ds.sql.execute(
            "CREATE TABLE jobs (id INTEGER PRIMARY KEY, state TEXT)")),
        2: make("second", lambda ds: ds.sql.execute(
            "INSERT INTO jobs VALUES (?, ?)", 1, "queued")),
    }


def test_migrations_through_app_as_jax():
    got = {}
    for side in SIDES:
        container = mock(side)
        app = mod(side, "app").App(config=config(side, {}),
                                   container=container)
        order = []
        migrations = migrations_for(side, order)
        app.migrate(migrations)
        app.migrate(migrations)                     # applies nothing
        runner = mod(side, "migration")
        journal = container.sql.select(
            "SELECT version, method FROM gofr_migrations ORDER BY version")
        hash_ = {k: sorted(json.loads(v)) for k, v in
                 container.redis.hgetall("gofr_migrations").items()}

        def bad(ds):
            ds.sql.execute("CREATE TABLE doomed (x INTEGER)")
            raise RuntimeError("boom")

        with pytest.raises(runner.MigrationError) as failed:
            app.migrate({4: runner.Migration(up=bad)})
        tables = container.sql.select(
            "SELECT name FROM sqlite_master WHERE type = 'table' "
            "ORDER BY name")
        refusals = []
        for bad_version in (0, -1, "5"):
            with pytest.raises(runner.MigrationError) as err:
                app.migrate({bad_version: runner.Migration(up=lambda ds:
                                                            None)})
            refusals.append(str(err.value))
        with pytest.raises(runner.MigrationError) as err:
            runner.Migration(up="not callable")
        refusals.append(str(err.value))
        got[side] = (order, journal, hash_, str(failed.value), tables,
                     refusals, runner.last_migration(container),
                     container.sql.select("SELECT * FROM jobs"),
                     container.redis.get("config:v"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["first", "second", "third"]


# -- Mongo, Cassandra, ClickHouse --------------------------------------------------

def mongo_program(seed, n=120):
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        op = rng.choice(["insert_one", "insert_many", "find", "find_one",
                         "update_by_id", "update_many", "delete_one",
                         "delete_many", "count"])
        filt = rng.choice([{}, {"n": rng.randint(0, 5)},
                           {"n": {"$gt": rng.randint(0, 5)}},
                           {"n": {"$in": [1, 3]}}, {"tag": "a"},
                           {"n": {"$ne": 2}, "tag": "b"}])
        ops.append((op, rng.choice(["c1", "c2"]), filt, rng.randint(0, 5),
                    rng.choice("ab")))
    return ops


def test_inmemory_mongo_seeded_program_as_jax():
    ops = mongo_program(5)
    got = {}
    for side in SIDES:
        container = mock(side)
        mongo = mod(side, "datasource.mongo").InMemoryMongo(
            container.logger, container.metrics)
        out, ids = [], []
        for op, coll, filt, n, tag in ops:
            if op == "insert_one":
                ids.append(mongo.insert_one(coll, {"n": n, "tag": tag}))
                out.append(ids[-1])
            elif op == "insert_many":
                out.append(mongo.insert_many(coll, [{"n": n}, {"n": n + 1,
                                                               "tag": tag}]))
            elif op == "find":
                out.append(mongo.find(coll, filt, limit=n))
            elif op == "find_one":
                out.append(mongo.find_one(coll, filt))
            elif op == "update_by_id":
                out.append(mongo.update_by_id(
                    coll, ids[n % len(ids)] if ids else 0, {"seen": n}))
            elif op == "update_many":
                out.append(mongo.update_many(coll, filt,
                                             {"$set": {"tag": tag}}))
            elif op == "count":
                out.append(mongo.count_documents(coll, filt))
            else:
                out.append(getattr(mongo, op)(coll, filt))
        mongo.drop_collection("c1")
        out.append(mongo.count_documents("c1"))
        out.append(mongo.health_check())
        got[side] = out
    assert got["port"] == got["jax"]


def test_nosql_mocks_record_as_jax():
    got = {}
    for side in SIDES:
        container = mock(side)
        nosql = mod(side, "datasource.nosql")
        app = mod(side, "app").App(config=config(side, {}),
                                   container=container)
        cass = nosql.MockCassandra(container.logger, container.metrics)
        cass.stub("FROM users", [{"id": 1, "name": "ada"}])
        click = nosql.MockClickhouse(container.logger, container.metrics)
        click.stub("FROM events", [{"x": 1}, {"x": 2}])
        app.add_cassandra(cass)
        app.add_clickhouse(click)
        app.add_mongo()                        # MONGO_URI unset: memory
        ctx = mod(side, "context").Context(None, container)
        out = [ctx.cassandra.query(None, "SELECT * FROM users WHERE id=?", 1),
               ctx.cassandra.exec("INSERT INTO users (id) VALUES (?)", 2),
               ctx.cassandra.exec_cas("UPDATE users SET x=1 IF y=2"),
               ctx.clickhouse.select(None, "SELECT x FROM events"),
               ctx.clickhouse.exec("CREATE TABLE t (x Int32)"),
               ctx.clickhouse.async_insert("INSERT INTO t VALUES", (1,)),
               type(ctx.mongo).__name__,
               cass.executed, click.executed,
               cass.health_check(), click.health_check()]
        health = container.health()
        out.append({k: health[k] for k in ("mongo", "cassandra",
                                           "clickhouse", "status")})
        got[side] = out
    assert got["port"] == got["jax"]


def test_gated_providers_over_stub_drivers_as_jax(monkeypatch):
    cluster_mod = _module("cassandra.cluster", Cluster=_FakeCluster)
    monkeypatch.setitem(sys.modules, "pymongo",
                        _module("pymongo", MongoClient=_FakeMongoClient))
    monkeypatch.setitem(sys.modules, "cassandra",
                        _module("cassandra", cluster=cluster_mod))
    monkeypatch.setitem(sys.modules, "cassandra.cluster", cluster_mod)
    monkeypatch.setitem(sys.modules, "clickhouse_driver",
                        _module("clickhouse_driver", Client=_FakeCHClient))
    values = {"MONGO_URI": "mongodb://db:27017", "MONGO_DATABASE": "appdb",
              "CASSANDRA_HOSTS": "n1,n2", "CASSANDRA_KEYSPACE": "ks",
              "CLICKHOUSE_HOST": "ch1", "CLICKHOUSE_DB": "metrics"}
    got = {}
    for side in SIDES:
        container = mock(side, values)
        mongo = mod(side, "datasource.mongo").new_mongo(
            container.config, container.logger, container.metrics)
        uid = mongo.insert_one("users", {"name": "ada"})
        mongo.insert_many("users", [{"name": "gus"}, {"name": "liz"}])
        out = [type(mongo).__name__, uid, mongo.count_documents("users"),
               mongo.find("users", limit=2),
               mongo.update_by_id("users", uid, {"name": "ada2"}),
               mongo.delete_many("users", {}), mongo.health_check()]
        mongo.close()
        nosql = mod(side, "datasource.nosql")
        cass = nosql.new_cassandra(container.config, container.logger,
                                   container.metrics)
        session = _FakeCluster.instances[-1].session
        session.rows = [{"id": 1, "name": "ada"}]
        out += [cass.query(None, "SELECT * FROM users WHERE id=%s", 1),
                cass.exec("INSERT INTO users (id) VALUES (%s)", 2),
                session.executed, cass.health_check()]
        click = nosql.new_clickhouse(container.config, container.logger,
                                     container.metrics)
        fake = _FakeCHClient.instances[-1]
        fake.rows, fake.columns = [(1, "a")], [("x", "Int32"), ("s", "S")]
        out += [click.select(None, "SELECT * FROM t WHERE x > ?", 0),
                click.exec("SELECT x FROM t WHERE s LIKE '%a?%' AND x = ?",
                           5),
                click.async_insert("INSERT INTO t VALUES", (3, "c")),
                fake.executed, fake.kwargs, click.health_check()]
        cass.close()
        click.close()
        got[side] = out
    assert got["port"] == got["jax"]


def test_missing_drivers_raise_as_jax():
    values = {"MONGO_URI": "mongodb://127.0.0.1:1",
              "CASSANDRA_HOSTS": "127.0.0.1", "CLICKHOUSE_HOST": "127.0.0.1"}
    got = {}
    for side in SIDES:
        container = mock(side, values)
        out = []
        for module, fn in (("datasource.mongo", "new_mongo"),
                           ("datasource.nosql", "new_cassandra"),
                           ("datasource.nosql", "new_clickhouse")):
            with pytest.raises(Exception) as err:
                getattr(mod(side, module), fn)(
                    container.config, container.logger, container.metrics)
            out.append((type(err.value).__name__, str(err.value)))
        got[side] = out
    assert got["port"] == got["jax"]


# -- the remote log level ----------------------------------------------------------

@pytest.mark.parametrize("doc", [
    {"level": "DEBUG"}, {"level": "warn"},
    {"data": [{"serviceLevel": {"logLevel": "ERROR"}}]},
    {"data": [{"serviceLevel": {}}]}, {"data": []}, {"data": "x"}, {},
    ["level"], "DEBUG", None, {"level": 3}])
def test_extract_level_as_jax(doc):
    got = [mod(side, "logging.remote_level")._extract_level(doc)
           for side in SIDES]
    assert got[1] == got[0]


def test_remote_level_poller_as_jax():
    docs = [b'{"level": "DEBUG"}', b"not json",
            b'{"data": [{"serviceLevel": {"logLevel": "ERROR"}}]}']
    served = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = docs[min(len(served), len(docs) - 1)]
            served.append(self.path)
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/level"
    got = {}
    try:
        for side in SIDES:
            served.clear()
            logging = mod(side, "logging")
            logger = logging.new_silent_logger()
            logger.change_level(logging.Level.INFO)
            levels = [logger.level.name]
            thread = mod(side, "logging.remote_level") \
                .start_remote_level_poller(logger, url, 0.01)
            deadline = time.monotonic() + 5.0
            while len(served) < 3 and time.monotonic() < deadline:
                if logger.level.name != levels[-1]:
                    levels.append(logger.level.name)
                time.sleep(0.001)
            thread.stop()
            thread.join(2.0)
            if logger.level.name != levels[-1]:
                levels.append(logger.level.name)
            got[side] = (levels, thread.is_alive())
    finally:
        server.shutdown()
        server.server_close()
    assert got["port"] == got["jax"] == (["INFO", "DEBUG", "ERROR"], False)


# -- the container and the app -----------------------------------------------------

def test_health_key_tree_as_jax(tmp_path):
    values = {"DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / "x.db"),
              "REDIS_HOST": "memory", "PUBSUB_BACKEND": "INMEM",
              "APP_NAME": "svc"}
    got = {}
    for side in SIDES:
        cm = mod(side, "container")
        kwargs = {} if side == "jax" else {"device": "cpu"}
        container = cm.Container.create(config(side, values),
                                        logger=silent(side), **kwargs)
        health = container.health()

        def tree(value):
            if isinstance(value, dict):
                return {k: tree(v) for k, v in value.items()
                        if k != "uptime_seconds"}
            return value if isinstance(value, str) else type(value).__name__

        got[side] = tree(health)
        asyncio.run(container.close())
        got[side]["closed"] = (container.sql._closed,)
    assert got["port"] == got["jax"]
    assert got["port"]["status"] == "UP"


def test_close_order_as_jax():
    got = {}
    for side in SIDES:
        container = mod(side, "container").Container(
            config=config(side, {}), logger=silent(side))
        order = []

        class Source:
            def __init__(self, name, fail=False):
                self.name, self.fail = name, fail

            def close(self):
                order.append(self.name)
                if self.fail:
                    raise RuntimeError(self.name)

            def health_check(self):
                return {"status": "UP", "details": {}}

        for name in ("sql", "redis", "pubsub", "mongo", "cassandra",
                     "clickhouse", "tpu"):
            setattr(container, name, Source(name, fail=name == "redis"))
        asyncio.run(container.close())
        got[side] = order
    assert got["port"] == got["jax"] == ["sql", "redis", "pubsub", "tpu"]


def test_mock_container_attributes_as_jax():
    names = ("sql", "redis", "pubsub", "mongo", "cassandra", "clickhouse",
             "file", "tpu", "tpu_batcher", "batch_lane", "cluster")
    got = {}
    for side in SIDES:
        container = mock(side)
        got[side] = ({n: type(getattr(container, n)).__name__
                      for n in names},
                     container.sql.dialect, container.sql.database,
                     container.redis.health_check())
    assert got["port"] == got["jax"]
