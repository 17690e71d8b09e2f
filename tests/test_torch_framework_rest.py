"""The rest of the port's framework held to the JAX package's on the same
inputs: the CLI (``run_cli`` over a table of argv, ``new_cmd`` with a log
file, and the exit code ``App.run`` hands back), the websocket codec
(frames made from a seed) and the websocket route (the same client bytes
to a JAX app and a port app, each serving nothing but the route), CRUD
over sqlite ``:memory:``, the OpenAPI routes, ``file_utils`` over seeded
zips, ``testutil`` and ``version``. Each case runs the same thing
through both packages and compares bytes, codes, statuses and bodies."""

import asyncio
import base64
import contextlib
import dataclasses
import importlib
import io
import json
import os
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch  # noqa: F401  (the port's app imports it at its first start)

PKGS = {"jax": "gofr_tpu", "port": "gofr_tpu_torch"}
SIDES = ("jax", "port")


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def run(coro):
    return asyncio.run(coro)


def mock_app(side, config=None):
    """An app over the package's mock container (silent logger, sqlite
    ``:memory:``, in-memory Redis and broker), every port 0."""
    kw = {"device": "cpu"} if side == "port" else {}
    container = mod(side, "container").new_mock_container(config, **kw)
    app = mod(side, "app").App(config=container.config,
                               container=container)
    app.http_port = app.metrics_port = app.grpc_port = 0
    return app


def normal(raw):
    """Status line, headers (the random trace ids replaced), body."""
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = []
    for line in lines[1:]:
        name, _, value = line.partition(":")
        if name.lower() in ("x-trace-id", "x-correlation-id"):
            value = "<id>"
        headers.append((name, value.strip()))
    return lines[0], headers, body


def http(method, path, body=b"", headers=None):
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    for key, value in (headers or {}).items():
        head += f"{key}: {value}\r\n"
    return (head + f"Content-Length: {len(body)}\r\nConnection: close"
            f"\r\n\r\n").encode() + body


async def raw_call(port, payload, timeout=10.0):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    await writer.drain()
    try:
        return await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()


# -- the CLI ------------------------------------------------------------------

def _cli_app(side):
    app = mock_app(side)
    seen = []

    def hello(ctx):
        seen.append(ctx.param("name"))
        return f"Hello {ctx.param('name')}!"

    async def later(ctx):
        await asyncio.sleep(0)
        return {"words": ctx.request.words, "params": ctx.params("a")}

    def echo(ctx):
        return {"bind": ctx.bind(), "path": ctx.request.path,
                "method": ctx.request.method, "flag": ctx.param("flag"),
                "id": ctx.path_param("id"), "header": ctx.header("x")}

    app.sub_command("hello", hello, description="greets",
                    help_text="hello -name=you")
    app.sub_command("log [a-z]+", lambda ctx: "ok")
    app.sub_command("boom", lambda ctx: 1 / 0, description="explodes")
    app.sub_command("later", later)
    app.sub_command("echo", echo)
    app.sub_command("none", lambda ctx: None)
    return app, seen


CLI_ARGV = [
    ["hello", "-name=ada"], ["hello", "--name=ada", "extra"], ["log", "info"],
    ["log", "INFO"], ["nope"], ["--help"], ["-h"], ["-help"], [], ["boom"],
    ["later", "-a=1,2,3"], ["echo", "--flag", "-id=7", "-k=v", "--="],
    ["none"], ["hello"],
]


@pytest.mark.parametrize("argv", CLI_ARGV, ids=lambda a: " ".join(a) or "-")
def test_run_cli_as_jax(argv):
    """stdout, stderr and the exit code of one argv, equal in both
    packages over the same handlers."""
    got = {}
    for side in SIDES:
        app, seen = _cli_app(side)
        out, err = io.StringIO(), io.StringIO()
        code = mod(side, "cli").run_cli(app, argv, stdout=out, stderr=err)
        got[side] = (code, out.getvalue(), err.getvalue(), seen)
    assert got["port"] == got["jax"]


def test_cli_request_and_responder_as_jax():
    got = {}
    for side in SIDES:
        command = mod(side, "cli.command")
        request = command.CLIRequest(["a", "-x=1,2", "--y", "b", "-", "--"])
        out, err = io.StringIO(), io.StringIO()
        responder = command.CLIResponder(out, err)
        codes = [responder.respond({"k": [1, 2]}, None),
                 responder.respond("text", None),
                 responder.respond(None, ValueError()),
                 responder.respond(None, KeyError("k"))]
        got[side] = (request.subcommand, request.words, request.params("x"),
                     request.param("y"), request.bind(), request.method,
                     request.path, codes, out.getvalue(), err.getvalue())
    assert got["port"] == got["jax"]


# JAX's own cases (tests/test_transports.py), against the port

def test_cli_command_dispatch_and_params():
    from gofr_tpu_torch.cli import run_cli
    app, seen = _cli_app("port")
    out = io.StringIO()
    assert run_cli(app, ["hello", "-name=ada"], stdout=out) == 0
    assert out.getvalue().strip() == "Hello ada!"
    assert seen == ["ada"]


def test_cli_regex_route_and_unknown():
    from gofr_tpu_torch.cli import run_cli
    app, _ = _cli_app("port")
    out, err = io.StringIO(), io.StringIO()
    assert run_cli(app, ["log", "info"], stdout=out, stderr=err) == 0
    assert run_cli(app, ["nope"], stdout=out, stderr=err) == 2
    assert "unknown command" in err.getvalue()


def test_cli_help_and_error_exit_code():
    from gofr_tpu_torch.cli import run_cli
    app, _ = _cli_app("port")
    out, err = io.StringIO(), io.StringIO()
    assert run_cli(app, ["--help"], stdout=out, stderr=err) == 0
    assert "boom" in out.getvalue()
    assert run_cli(app, ["boom"], stdout=out, stderr=err) == 1


def test_app_run_returns_the_exit_code_where_jax_returns_none(monkeypatch):
    """JAX's ``App.run`` drops ``run_cli``'s code (its ``cmd`` example
    exits 0 on an unknown command); the port's returns it, so the port's
    ``cmd`` example exits 2."""
    import subprocess

    got = {}
    for side in SIDES:
        app, _ = _cli_app(side)
        monkeypatch.setattr(sys, "argv", ["prog", "nosuch"])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            got[side] = app.run()
        assert "unknown command: 'nosuch'" in err.getvalue()
        assert mod(side, "cli").run_cli(app, ["nosuch"],
                                        stderr=io.StringIO()) == 2
    assert got == {"jax": None, "port": 2}
    env = {k: v for k, v in os.environ.items() if k != "CMD_LOGS_FILE"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.examples.cmd", "nosuch"],
        cwd=root, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "unknown command: 'nosuch'" in proc.stderr
    assert proc.stdout == ""


def test_new_cmd_logs_to_the_file_and_leaves_stdout_clean(
        tmp_path, monkeypatch, capsys):
    from gofr_tpu_torch import new_cmd
    from gofr_tpu_torch.cli import run_cli

    log_file = tmp_path / "cmd.log"
    monkeypatch.setenv("CMD_LOGS_FILE", str(log_file))
    app = new_cmd(str(tmp_path / "configs"), device="cpu")
    assert app.container.device == "cpu"

    def noisy(ctx):
        ctx.logger.info("noisy ran", n=3)
        ctx.logger.error("noisy error")
        return "result line"

    app.sub_command("noisy", noisy)
    out = io.StringIO()
    assert run_cli(app, ["noisy"], stdout=out) == 0
    assert out.getvalue() == "result line\n"
    captured = capsys.readouterr()
    assert captured.out == "" and captured.err == ""
    lines = [json.loads(line) for line in log_file.read_text().splitlines()]
    assert [ln["message"] for ln in lines if "noisy" in ln["message"]] == [
        "noisy ran", "noisy error"]


# -- the websocket codec --------------------------------------------------------

OPCODES = ("OP_TEXT", "OP_BINARY", "OP_PING", "OP_PONG", "OP_CLOSE",
           "OP_CONT")
WS_LENGTHS = (0, 125, 126, 65535, 65536)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("length", WS_LENGTHS)
def test_frame_codec_as_jax(length, masked, monkeypatch):
    """``encode_frame`` / ``decode_frame`` over seeded payloads of every
    opcode, fin on and off: equal bytes (the mask key fixed), equal
    decodes of the whole frame and of each cut of its header, equal
    refusals (an unmasked frame where a mask is required, a frame over
    ``max_length``)."""
    rng = np.random.default_rng(length * 2 + masked)
    payload = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
    key = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
    monkeypatch.setattr(os, "urandom", lambda n: key[:n])
    got = {}
    for side in SIDES:
        frames = mod(side, "websocket.frames")
        rows = []
        # the long payloads (masked byte by byte) at two opcodes
        for name in OPCODES if length < 65535 else OPCODES[:2]:
            for fin in (True, False):
                blob = frames.encode_frame(getattr(frames, name), payload,
                                           fin=fin, mask=masked)
                rows.append((blob, frames.decode_frame(blob),
                             [frames.decode_frame(blob[:cut])
                              for cut in (0, 1, 2, 3, 9, 13, len(blob) - 1)
                              if cut < len(blob)]))
                for kw in (dict(require_mask=True),
                           dict(max_length=max(length - 1, 0))):
                    try:
                        rows.append(frames.decode_frame(blob, **kw)[:3])
                    except ValueError as exc:
                        rows.append((type(exc).__name__, str(exc),
                                     exc.close_code))
        got[side] = rows
    assert got["port"] == got["jax"]


def test_close_and_accept_key_as_jax():
    rng = np.random.default_rng(9)
    keys = [base64.b64encode(rng.integers(0, 256, 16, dtype=np.uint8)
                             .tobytes()).decode() for _ in range(4)]
    got = {}
    for side in SIDES:
        frames = mod(side, "websocket.frames")
        got[side] = ([frames.accept_key(k) for k in keys + [""]],
                     [frames.encode_close(code, reason)
                      for code in (1000, 1002, 1009, 4000)
                      for reason in (b"", b"bye")],
                     frames.MAGIC_GUID, frames.CLOSE_PROTOCOL_ERROR,
                     frames.CLOSE_MESSAGE_TOO_BIG)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] != got["port"][0][1]


# -- the websocket route ---------------------------------------------------------

WS_KEY = "dGhlIHNhbXBsZSBub25jZQ=="


def _upgrade(path="/ws", key=WS_KEY, upgrade=True):
    head = f"GET {path} HTTP/1.1\r\nHost: x\r\n"
    head += ("Upgrade: websocket\r\nConnection: Upgrade\r\n" if upgrade
             else "Connection: close\r\n")
    if key:
        head += f"Sec-WebSocket-Key: {key}\r\n"
    return (head + "Sec-WebSocket-Version: 13\r\n\r\n").encode()


def _ws_handlers(side):
    async def echo(ctx):
        while True:
            message = await ctx.read_message()
            await ctx.write_message(f"echo: {message}")

    async def as_json(ctx):
        message = await ctx.read_message()
        await ctx.write_message({"got": message,
                                 "q": ctx.param("q"), "id":
                                 ctx.path_param("id")})

    async def feed(ctx):
        for i in range(3):
            await ctx.write_message(f"tick {i}")
        await ctx.write_message(b"\x00\x01")
        await ctx.read_message()

    def plain(ctx):
        return None

    return {"/ws": echo, "/json/{id}": as_json, "/feed": feed,
            "/plain": plain}


def _frame(side, name, payload, fin=True, mask=True):
    frames = mod(side, "websocket.frames")
    return frames.encode_frame(getattr(frames, name), payload, fin=fin,
                               mask=mask)


# each case: (path, [client writes], frames the server sends before the
# case ends (None: read to the server's close), stop the app with the
# socket live)
WS_CASES = {
    "echo": ("/ws", [("OP_TEXT", b"hi")], 1, False),
    "json": ("/json/7?q=a", [("OP_TEXT", b"42")], None, False),
    "ping": ("/ws", [("OP_PING", b"x"), ("OP_PONG", b"y"),
                     ("OP_TEXT", b"after")], 2, False),
    "fragments": ("/ws", [("OP_TEXT", b"ab", False),
                          ("OP_CONT", b"cd", False),
                          ("OP_CONT", b"ef", True)], 1, False),
    "binary": ("/ws", [("OP_BINARY", b"\xff\x00")], 1, False),
    "unmasked": ("/ws", [("OP_TEXT", b"hi", True, False)], None, False),
    "oversized": ("/ws", [b"\x81\xff" + struct.pack(">Q", 1 << 40)
                          + b"\x00" * 4], None, False),
    "close": ("/ws", [("OP_CLOSE", b"\x03\xe8")], None, False),
    "server_push": ("/feed", [], 4, False),
    "plain_def": ("/plain", [], None, False),
    "shutdown": ("/ws", [("OP_TEXT", b"one")], 1, True),
}


async def _ws_case(side, case):
    path, writes, frames_wanted, stop_live = WS_CASES[case]
    app = mock_app(side)
    for route, handler in _ws_handlers(side).items():
        app.websocket(route, handler)
    decode = mod(side, "websocket.frames").decode_frame
    await app.start()
    stopped = False
    try:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", app.bound_http_port)
        writer.write(_upgrade(path))
        for item in writes:
            writer.write(item if isinstance(item, bytes)
                         else _frame(side, *item))
        await writer.drain()
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
        buffer = b""
        frames = []
        while frames_wanted is None or len(frames) < frames_wanted:
            frame = decode(buffer)
            if frame is not None:
                frames.append(frame[:3])
                buffer = buffer[frame[3]:]
                continue
            chunk = await asyncio.wait_for(reader.read(4096), 10)
            if not chunk:
                break
            buffer += chunk
        if stop_live:
            await asyncio.wait_for(app.stop(), 10)
            stopped = True
            rest = await asyncio.wait_for(reader.read(), 10)
            frames.append(decode(rest)[:3] if rest else None)
        writer.close()
    finally:
        if not stopped:
            await app.stop()
    return normal(head), frames, buffer


@pytest.mark.parametrize("case", sorted(WS_CASES))
def test_websocket_route_as_jax(case):
    """The same client bytes to a JAX app and a port app: the handshake
    response and every frame the server sends back are equal (echo, a
    JSON reply with query and path params, ping and pong, reassembled
    fragments, 1002 on an unmasked frame, 1009 on a frame declaring
    2**40 bytes, the close handshake, server pushes, a plain ``def``
    handler, and shutdown with the socket live)."""
    got = {side: run(_ws_case(side, case)) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "HTTP/1.1 101 Switching Protocols"


@pytest.mark.parametrize("request_bytes", [
    _upgrade(upgrade=False), _upgrade(key="").replace(
        b"Connection: Upgrade", b"Connection: close"),
    http("GET", "/ws")], ids=["no-upgrade", "no-key", "plain-get"])
def test_websocket_refusals_as_jax(request_bytes):
    """426 without the upgrade headers, 400 without a key."""
    async def main(side):
        app = mock_app(side)
        app.websocket("/ws", lambda ctx: None)
        await app.start()
        try:
            return normal(await raw_call(app.bound_http_port,
                                         request_bytes))
        finally:
            await app.stop()

    got = {side: run(main(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"][0].split()[1] in ("426", "400")


class FakeTransport:
    def __init__(self):
        self.sent = b""
        self.closed = False

    def write(self, data):
        self.sent += data

    def is_closing(self):
        return self.closed

    def close(self):
        self.closed = True


def test_fragment_flood_and_hub_as_jax():
    """A fragment stream past ``max_message_bytes`` closes with 1009;
    the hub adds, finds, broadcasts and drops closed connections."""
    async def main(side):
        conn_mod = mod(side, "websocket.connection")
        transport = FakeTransport()
        conn = conn_mod.Connection(transport, "k", "/ws",
                                   max_message_bytes=1024)
        conn.feed(_frame(side, "OP_TEXT", b"x" * 512, fin=False))
        mid = transport.closed
        conn.feed(_frame(side, "OP_CONT", b"y" * 600, fin=False))
        flood = (mid, transport.closed, transport.sent)
        hub = conn_mod.ConnectionHub()
        live, gone = FakeTransport(), FakeTransport()
        a = conn_mod.Connection(live, "a", "/ws")
        b = conn_mod.Connection(gone, "b", "/ws")
        hub.add(a)
        hub.add(b)
        b.close()
        await hub.broadcast({"m": 1})
        a.feed(b"")
        try:
            await a.read_message()
            closed = None
        except conn_mod.ConnectionClosed as exc:
            closed = type(exc).__name__
        return (flood, live.sent, gone.sent, [c.key for c in hub.all()],
                hub.get("a") is a, closed, a.method, a.param("x"),
                a.params("x"), a.header("h"))

    got = {side: run(main(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == (False, True)


# -- CRUD ---------------------------------------------------------------------

@dataclasses.dataclass
class User:
    id: int = 0
    name: str = ""
    age: int = 0
    is_employed: bool = False


@dataclasses.dataclass
class Person:
    pid: int = 0
    nick: str = ""

    @staticmethod
    def table_name():
        return "people"

    @staticmethod
    def rest_path():
        return "persons"


@dataclasses.dataclass
class OnlyKey:
    key: int = 0


JSON = {"Content-Type": "application/json"}
CRUD_SEQUENCE = [
    ("POST", "/user", {"id": 1, "name": "ada", "age": 36,
                       "is_employed": True}),
    ("POST", "/user", {"id": 2, "name": "bob", "age": 40}),
    ("GET", "/user", None), ("GET", "/user/1", None),
    ("PUT", "/user/1", {"id": 1, "name": "ada", "age": 37,
                        "is_employed": False}),
    ("GET", "/user/1", None), ("DELETE", "/user/1", None),
    ("GET", "/user/1", None), ("PUT", "/user/9", {"name": "x"}),
    ("DELETE", "/user/9", None), ("POST", "/user", b"{bad"),
    ("POST", "/user", {"id": 3, "unknown": 1}),
    ("GET", "/user", None),
    ("POST", "/persons", {"pid": 5, "nick": "p"}),
    ("GET", "/persons", None), ("GET", "/persons/5", None),
    ("PUT", "/persons/5", {"pid": 5, "nick": "q"}),
    ("DELETE", "/persons/5", None), ("GET", "/persons/5", None),
    ("PUT", "/only_key/1", {"key": 1}),
]


def test_crud_routes_as_jax():
    """Two entities (the example's ``User``; one with ``table_name`` and
    ``rest_path`` overrides) and one with nothing but its key: the same
    request sequence gives equal statuses and bodies, and the same
    routes."""
    async def main(side):
        app = mock_app(side)
        app.container.sql.execute(
            "CREATE TABLE user (id INTEGER PRIMARY KEY, name TEXT, "
            "age INTEGER, is_employed BOOLEAN)")
        app.container.sql.execute(
            "CREATE TABLE people (pid INTEGER PRIMARY KEY, nick TEXT)")
        app.container.sql.execute(
            "CREATE TABLE only_key (key INTEGER PRIMARY KEY)")
        for entity in (User, Person, OnlyKey):
            app.add_rest_handlers(entity)
        with pytest.raises(TypeError, match="needs a dataclass"):
            app.add_rest_handlers(dict)
        out = [app.router.registered_routes]
        await app.start()
        try:
            for method, path, body in CRUD_SEQUENCE:
                data = body if isinstance(body, bytes) else (
                    json.dumps(body).encode() if body is not None else b"")
                out.append(normal(await raw_call(
                    app.bound_http_port, http(method, path, data, JSON))))
        finally:
            await app.stop()
        return out

    got = {side: run(main(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    statuses = [line[0].split()[1] for line in got["port"][1:]]
    assert statuses[:8] == ["201", "201", "200", "200", "200", "200", "204",
                            "404"]


# -- OpenAPI ---------------------------------------------------------------------

SPEC = {"openapi": "3.0.0", "info": {"title": "T", "version": "1"},
        "paths": {"/hello": {"get": {"summary": "hi"}}}}
OPENAPI_PATHS = ["/.well-known/openapi.json", "/.well-known/swagger",
                 "/.well-known/swagger/swagger-ui-bundle.js",
                 "/.well-known/swagger/swagger-ui.css",
                 "/.well-known/swagger/..%2Fopenapi.py",
                 "/.well-known/swagger/favicon.ico"]


@pytest.mark.parametrize("spec", ["good", "broken", "none"])
def test_openapi_routes_as_jax(spec, tmp_path, monkeypatch):
    """In a working directory holding ``static/openapi.json``: the spec,
    the UI page and both swagger-ui assets are JAX's bytes, a traversal
    name is a 404; a broken spec is refused as JAX refuses it; with no
    spec there are no routes."""
    if spec != "none":
        (tmp_path / "static").mkdir()
        (tmp_path / "static" / "openapi.json").write_text(
            json.dumps(SPEC) if spec == "good" else "{not json")
    monkeypatch.chdir(tmp_path)

    async def main(side):
        app = mock_app(side)
        await app.start()
        try:
            return [normal(await raw_call(app.bound_http_port,
                                          http("GET", path)))
                    for path in OPENAPI_PATHS]
        finally:
            await app.stop()

    got = {side: run(main(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    status = [line[0].split()[1] for line in got["port"]]
    want = {"good": ["200", "200", "200", "200", "404", "404"],
            "broken": ["500", "200", "200", "200", "404", "404"],
            "none": ["404"] * 6}[spec]
    assert status == want
    if spec == "good":
        assert len(got["port"][2][2]) > 100_000


# -- file_utils -------------------------------------------------------------------

def _zip(members, stored=False):
    buffer = io.BytesIO()
    method = zipfile.ZIP_STORED if stored else zipfile.ZIP_DEFLATED
    with zipfile.ZipFile(buffer, "w", method) as archive:
        for name, content in members:
            if name.endswith("/"):
                archive.writestr(zipfile.ZipInfo(name), b"")
            else:
                archive.writestr(name, content)
    return buffer.getvalue()


def _lying(blob, size):
    """Every size field of a one-member stored zip set to ``size``."""
    data = bytearray(blob)
    local = data.index(b"PK\x03\x04")
    struct.pack_into("<II", data, local + 18, size, size)
    central = data.index(b"PK\x01\x02")
    struct.pack_into("<II", data, central + 20, size, size)
    return bytes(data)


def _zip_cases():
    rng = np.random.default_rng(24)

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    return {
        "members": (_zip([("a.txt", b"alpha"), ("d/", b""),
                          ("d/b.bin", blob(3000)), ("d/e/c", blob(10))]),
                    None),
        "empty": (_zip([]), None),
        "declared_bomb": (_zip([("big", bytes(5000)), ("s", b"x")]), 4096),
        "actual_over": (_zip([("a", blob(600)), ("b", blob(600))]), 1100),
        "lying_header": (_lying(_zip([("x", blob(1000))], stored=True), 10),
                         None),
        "declared_huge": (_lying(_zip([("x", blob(64))], stored=True),
                                 200 * 1024 * 1024), None),
        "dotdot": (_zip([("ok", b"1"), ("../evil.txt", b"x")]), None),
        "inner_dotdot": (_zip([("a/../../b", b"x")]), None),
        "absolute": (_zip([("/abs.txt", b"x")]), None),
        "not_a_zip": (blob(100), None),
    }


@pytest.mark.parametrize("case", sorted(_zip_cases()))
def test_unzip_as_jax(case, tmp_path):
    """Seeded zips give JAX's members, or raise JAX's exception with its
    message: a declared bomb, an expansion past the limit, a header that
    understates a member (``BadZipFile``: Bad CRC-32), ``../`` and
    absolute names; ``unzip_to_dir`` writes the same tree."""
    data, limit = _zip_cases()[case]
    kw = {} if limit is None else {"max_bytes": limit}
    got = {}
    for side in SIDES:
        fu = mod(side, "file_utils")
        try:
            result = ("ok", fu.unzip_bytes(data, **kw))
        except Exception as exc:
            result = ("raised", type(exc).__name__, str(exc))
        root = tmp_path / side
        root.mkdir()
        try:
            count = fu.unzip_to_dir(data, str(root), **kw)
        except Exception as exc:
            count = type(exc).__name__
        tree = sorted((str(p.relative_to(root)), p.read_bytes())
                      for p in root.rglob("*") if p.is_file())
        got[side] = (result, count, tree)
    assert got["port"] == got["jax"]
    raised = {"declared_bomb": "ZipBombError", "actual_over": "ZipBombError",
              "lying_header": "BadZipFile", "declared_huge": "ZipBombError",
              "dotdot": "ZipBombError", "inner_dotdot": "ZipBombError",
              "absolute": "ZipBombError", "not_a_zip": "BadZipFile"}
    if case in raised:
        assert got["port"][0][:2] == ("raised", raised[case])
    assert mod("port", "file_utils").MAX_UNZIP_BYTES == \
        mod("jax", "file_utils").MAX_UNZIP_BYTES == 100 * 1024 * 1024


# -- testutil, version, the package's names -----------------------------------------

def test_testutil_and_version_as_jax():
    def noisy():
        print("out line")
        print("err line", file=sys.stderr)

    got = {}
    for side in SIDES:
        tu = mod(side, "testutil")
        error = tu.CustomError()
        custom = tu.CustomError("boom")
        got[side] = (tu.stdout_output_for_func(noisy),
                     tu.stderr_output_for_func(noisy),
                     str(error), error.message, custom.message,
                     isinstance(custom, Exception),
                     mod(side, "version").FRAMEWORK_VERSION)
    assert got["port"] == got["jax"]


def test_package_exports_jax_names():
    import gofr_tpu
    import gofr_tpu_torch

    assert set(gofr_tpu.__all__) <= set(gofr_tpu_torch.__all__)
    assert gofr_tpu_torch.__version__ == gofr_tpu.__version__
    assert gofr_tpu_torch.App is mod("port", "app").App
    assert gofr_tpu_torch.Context is mod("port", "context").Context
    from gofr_tpu_torch.container import FRAMEWORK_VERSION
    assert FRAMEWORK_VERSION is gofr_tpu_torch.FRAMEWORK_VERSION
    for name in ("cli", "websocket"):
        assert mod("port", name).__all__ == mod("jax", name).__all__
