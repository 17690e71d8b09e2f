"""The port's ``/debug/*`` pages against JAX's on the CPU: a JAX ``App``
and a port ``App`` (``device="cpu"``), each over a tiny engine (the
``tiny`` preset at f32, the same weights: JAX's ``llama.init`` carried
across by ``convert.from_jax_llama``), every page enabled on both, the
same greedy requests through both. Each app serves on an event loop of
its own thread for the module.

- every page's payload has JAX's key tree, with the exceptions of
  ``tests/test_torch_telemetry.py`` (the port's own ``stats()`` keys)
  where the engine's stats sit in the page, and no other; the
  ``/debug/`` index is equal; the
  deterministic values are equal: request and token counts, compiles by
  cause (``serving_compiles`` aside), the operating point, budgets;
- the profiler answers JAX's status strings with JAX's keys for start,
  already profiling, stop and not profiling; its state is per App; it
  clamps ``duration_s``; it stops by itself at the deadline; it leaves a
  ``trace.json`` that parses (JAX's side run as
  ``tests/test_multihost_profiler.py`` runs it);
- ``clusterz._extract_view`` and ``build_clusterz`` over canned probes
  (fresh, draining, circuit open, a failing probe) give JAX's view;
  ``build_tracez`` falls back to the local flight records as JAX's does.

Greedy tokens at f32 are compared exactly; no other comparison is
numeric.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest

from test_torch_telemetry import (OP_POINT_VALUES_APART, PORT_STATS,
                                  STATS_EQUAL, VIEW_EXCEPTIONS)

SIDES = ("jax", "port")
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1]]
BUDGET = 6
ENGINE_KW = dict(max_slots=2, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CONFIG = {"APP_NAME": "pages", "APP_VERSION": "t", "LOG_LEVEL": "FATAL"}
PAGES = ("statusz", "varz", "xlaz", "hbmz", "timez", "workloadz", "sloz",
         "whyz", "tunez", "clusterz")
# where each page carries the engine's stats() (or health_check()'s
# details, which are stats()): VIEW_EXCEPTIONS's roots, as each page
# nests them
STATS_ROOTS = {"statusz": ("/engine/stats", "/devices/details"),
               "varz": ("/engine",)}


class LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


async def _request(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else b""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/json\r\nContent-Length: "
                      f"{len(data)}\r\nConnection: close\r\n\r\n").encode()
                     + data)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in
               (line.partition(":") for line in lines[1:])}
    return int(lines[0].split()[1]), headers, json.loads(payload or b"null")


def _weights():
    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import llama as jax_llama

    cfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return cfg, jax.tree.map(np.asarray,
                             jax_llama.init(cfg, jax.random.PRNGKey(0)))


def _enable_all(app):
    for name in ("statusz", "varz", "xlaz", "hbmz", "timez", "workloadz",
                 "sloz", "whyz", "tunez", "clusterz", "tracez", "profiler"):
        getattr(app, f"enable_{name}")()


def _generate_route(engine):
    async def generate(ctx):
        await engine.start()
        out = await engine.generate(ctx.bind()["prompt"], BUDGET)
        return {"tokens": out}
    return generate


def _build(side, jcfg, weights):
    """An App over a tiny engine with every page enabled and a
    ``POST /gen`` route into the engine."""
    if side == "jax":
        from gofr_tpu.app import App
        from gofr_tpu.config import MapConfig
        from gofr_tpu.tpu.generate import GenerationEngine
        app = App(config=MapConfig(CONFIG))
        cfg, params, kw = jcfg, weights, {}
    else:
        import torch

        from gofr_tpu_torch.app import App
        from gofr_tpu_torch.config import MapConfig
        from gofr_tpu_torch.models import llama
        from gofr_tpu_torch.models.convert import from_jax_llama
        from gofr_tpu_torch.tpu.generate import GenerationEngine
        app = App(config=MapConfig(CONFIG), device="cpu")
        cfg = llama.config("tiny", dtype=torch.float32, use_flash=True)
        params, kw = from_jax_llama(weights, device="cpu"), {"device": "cpu"}
    container = app.container
    engine = GenerationEngine(cfg, params, logger=container.logger,
                              metrics=container.metrics,
                              tracer=container.tracer, slo=container.slo,
                              **ENGINE_KW, **kw)
    container.tpu = engine
    _enable_all(app)
    app.post("/gen", _generate_route(engine))
    app.http_port = app.metrics_port = app.grpc_port = 0
    return app


@pytest.fixture(scope="module")
def served():
    loop = LoopThread()
    jcfg, weights = _weights()
    apps = {side: _build(side, jcfg, weights) for side in SIDES}
    out = {"apps": apps, "loop": loop, "tokens": {}, "trace_ids": {},
           "pages": {}}
    try:
        for app in apps.values():
            loop.run(app.start())
        for side, app in apps.items():
            got = [loop.run(_request(app.bound_http_port, "POST", "/gen",
                                     {"prompt": p})) for p in PROMPTS]
            out["tokens"][side] = [g[2]["data"]["tokens"] for g in got]
            out["trace_ids"][side] = [g[1]["x-trace-id"] for g in got]
            pages = {name: loop.run(_request(app.bound_http_port, "GET",
                                             f"/debug/{name}"))
                     for name in PAGES + ("",)}
            tid = out["trace_ids"][side][0]
            for name in ("whyz", "tracez"):
                pages[f"{name}/id"] = loop.run(_request(
                    app.bound_http_port, "GET", f"/debug/{name}/{tid}"))
            out["pages"][side] = pages
        yield out
    finally:
        for app in apps.values():
            loop.run(app.stop())
        loop.close()


def _paths(tree, prefix=""):
    out = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            path = f"{prefix}/{key}"
            out.add(path)
            out |= _paths(value, path)
    return out


def _excepted(page, path):
    """``test_torch_telemetry._excepted`` at each of the page's roots of
    the engine's stats (a prefix of the path, as there)."""
    for root in STATS_ROOTS.get(page, ()):
        for prefix in VIEW_EXCEPTIONS:
            key = prefix.split("/", 2)[2]
            if key in PORT_STATS and path.startswith(f"{root}/{key}"):
                return True
    return False


def test_greedy_tokens_through_both_apps_are_equal(served):
    assert served["tokens"]["port"] == served["tokens"]["jax"]
    assert all(len(t) == BUDGET for t in served["tokens"]["port"])


def test_debug_index_is_jax(served):
    pages = {side: served["pages"][side][""] for side in SIDES}
    assert pages["port"][0] == pages["jax"][0] == 200
    assert pages["port"][2] == pages["jax"][2]
    assert served["apps"]["port"].debug_index() \
        == served["apps"]["jax"].debug_index()
    assert len(pages["port"][2]["data"]) == 12


@pytest.mark.parametrize("page", PAGES + ("whyz/id", "tracez/id"))
def test_page_has_jax_key_tree(served, page):
    got = {side: served["pages"][side][page] for side in SIDES}
    assert got["port"][0] == got["jax"][0] == 200
    trees = {side: {p for p in _paths(got[side][2]["data"])
                    if not _excepted(page.split("/")[0], p)}
             for side in SIDES}
    assert trees["port"] == trees["jax"]


def _data(served, side, page):
    return served["pages"][side][page][2]["data"]


def _point(view):
    return {k: v for k, v in view.items() if k not in OP_POINT_VALUES_APART}


def test_page_values_as_jax(served):
    """The deterministic values of every page are JAX's."""
    pages = {side: {page: _data(served, side, page)
                    for page in PAGES + ("whyz/id", "tracez/id")}
             for side in SIDES}
    jax, port = pages["jax"], pages["port"]
    # statusz: requests, tokens, stats counters, the cache, the planes
    for side in SIDES:
        assert pages[side]["statusz"]["app"] == {
            "name": "pages", "version": "t", "debug_index": "/debug/"}
        engine = pages[side]["statusz"]["engine"]
        assert engine["requests"]["total_requests"] == len(PROMPTS)
        assert engine["queue_depth"] == 0
    for key in STATS_EQUAL + ("classes", "free_slots", "model"):
        assert port["statusz"]["engine"]["stats"][key] \
            == jax["statusz"]["engine"]["stats"][key], key
        assert port["varz"]["engine"][key] == jax["varz"]["engine"][key]
    assert port["statusz"]["engine"]["kv_cache"] \
        == jax["statusz"]["engine"]["kv_cache"]
    for key in ("watchdog", "profiler"):
        assert port["statusz"][key] == jax["statusz"][key], key
    for window in ("60s", "300s"):
        assert port["varz"]["slo"][window]["outcomes"] \
            == jax["varz"]["slo"][window]["outcomes"] \
            == {"error": 0, "expired": 0, "ok": 3.0, "violated": 0}
    assert port["varz"]["slo"]["lifetime"] == jax["varz"]["slo"]["lifetime"]
    assert port["statusz"]["slo"]["lifetime"]["tokens_total"] \
        == len(PROMPTS) * BUDGET
    # xlaz and tunez: compiles by cause (serving_compiles aside: the
    # port counts graph captures, none on the CPU), the operating point,
    # the prompt fit, the padding
    assert {k: v for k, v in port["xlaz"]["compiles"].items()
            if k != "serving"} == {k: v for k, v in
                                   jax["xlaz"]["compiles"].items()
                                   if k != "serving"}
    assert _point(port["xlaz"]["operating_point"]) \
        == _point(jax["xlaz"]["operating_point"])
    assert _point(port["tunez"]["operating_point"]) \
        == _point(jax["tunez"]["operating_point"])
    assert port["tunez"]["enabled"] is jax["tunez"]["enabled"] is False
    for key in ("models", "batcher"):
        assert port["xlaz"][key] == jax["xlaz"][key], key
    assert port["xlaz"]["padding"]["lifetime"] \
        == jax["xlaz"]["padding"]["lifetime"]
    # hbmz: the parameters, no allocator figure on the CPU
    for key in ("model", "params_bytes", "page_pool", "occupancy",
                "device_bytes_in_use"):
        assert port["hbmz"][key] == jax["hbmz"][key], key
    # sloz: the budgets, the watchdog, the offender ring's counts
    assert port["sloz"]["slo_budget"] == jax["sloz"]["slo_budget"]
    assert port["sloz"]["watchdog"] == jax["sloz"]["watchdog"]
    for key in ("diagnosed", "offered", "k", "keep_windows", "window_s"):
        assert port["sloz"]["worst_offenders"][key] \
            == jax["sloz"]["worst_offenders"][key], key
    # workloadz: the traffic's shape
    for key in ("admitted_total", "finished_total", "class_mix",
                "finish_mix", "output_len", "prompt_len", "capacity"):
        assert port["workloadz"]["workload"][key] \
            == jax["workloadz"]["workload"][key], key
    assert port["timez"]["signals"] == jax["timez"]["signals"]
    # whyz and tracez for one request: the offender ring's entry, the
    # one local flight record
    assert port["whyz/id"]["source"] == jax["whyz/id"]["source"] \
        == "offender_ring"
    for side in SIDES:
        tracez = pages[side]["tracez/id"]
        assert tracez["stitched"] is False and len(tracez["records"]) == 1
        assert tracez["trace_id"] == served["trace_ids"][side][0]
    assert port["clusterz"] == jax["clusterz"] == {
        "error": "no cluster registered", "replicas": {}}


# -- the profiler -------------------------------------------------------------

def _bare_app(side):
    if side == "jax":
        from gofr_tpu.app import App
        from gofr_tpu.config import MapConfig
        app = App(config=MapConfig(CONFIG))
    else:
        from gofr_tpu_torch.app import App
        from gofr_tpu_torch.config import MapConfig
        app = App(config=MapConfig(CONFIG), device="cpu")
    app.enable_profiler()
    app.enable_statusz()
    app.http_port = app.metrics_port = app.grpc_port = 0
    return app


def _profile_sequence(served, side, trace_dir):
    """Start (duration clamped), already profiling, the other App's stop,
    stop, not profiling; then a capture that stops at its deadline."""
    loop, app = served["loop"], served["apps"][side]
    other = _bare_app(side)
    port = app.bound_http_port
    out = []

    def call(a_port, path, body=None):
        status, _, payload = loop.run(_request(a_port, "POST", path, body))
        return status, payload["data"]

    loop.run(other.start())
    try:
        out.append(call(port, "/debug/profiler/start",
                        {"dir": trace_dir, "duration_s": 1000}))
        # work during the capture
        loop.run(_request(port, "POST", "/gen", {"prompt": PROMPTS[0]}))
        again = call(port, "/debug/profiler/start", {"dir": "elsewhere"})
        out.append((again[0], {k: (v if k != "remaining_s" else v > 100)
                               for k, v in again[1].items()}))
        out.append(call(other.bound_http_port, "/debug/profiler/stop"))
        out.append(call(port, "/debug/profiler/stop"))
        out.append(call(port, "/debug/profiler/stop"))
        short_dir = trace_dir + "-deadline"
        out.append(call(port, "/debug/profiler/start",
                        {"dir": short_dir, "duration_s": 0.001}))
        deadline = time.monotonic() + 30
        while True:
            status = loop.run(_request(port, "GET", "/debug/statusz"))[2][
                "data"]["profiler"]
            if not status["running"] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        out.append(status)
        out.append(call(port, "/debug/profiler/stop"))
    finally:
        loop.run(other.stop())
    return out


@pytest.fixture(scope="module")
def profiled(served, tmp_path_factory):
    root = tmp_path_factory.mktemp("profiles")
    return {side: (str(root / side),
                   _profile_sequence(served, side, str(root / side)))
            for side in SIDES}


def test_profiler_answers_as_jax(profiled):
    """JAX's status strings, keys and values for start (``duration_s``
    clamped to 120), already profiling, stop, not profiling; the other
    App's stop does not end this App's capture."""
    def shape(side):
        trace_dir, seq = profiled[side]
        return json.loads(json.dumps(seq).replace(trace_dir, "DIR"))

    got = {side: shape(side) for side in SIDES}
    assert got["port"][:5] == got["jax"][:5] == [
        [201, {"status": "started", "dir": "DIR", "duration_s": 120.0}],
        [201, {"status": "already profiling", "dir": "DIR",
               "remaining_s": True}],
        [201, {"status": "not profiling", "last_artifact_dir": None}],
        [201, {"status": "stopped", "dir": "DIR"}],
        [201, {"status": "not profiling", "last_artifact_dir": "DIR"}]]


def test_profiler_stops_at_its_deadline_as_jax(profiled):
    """``duration_s`` is clamped to 0.1 s below; the capture stops by
    itself, counted, its dir the last artifact's, and a stop after it
    answers not profiling."""
    for side in SIDES:
        trace_dir, seq = profiled[side]
        assert seq[5] == (201, {"status": "started",
                                "dir": trace_dir + "-deadline",
                                "duration_s": 0.1})
        assert seq[6] == {"enabled": True, "running": False, "captures": 2,
                          "last_artifact_dir": trace_dir + "-deadline"}
        assert seq[7] == (201, {"status": "not profiling",
                                "last_artifact_dir": trace_dir
                                + "-deadline"})


def test_profiler_trace_json_parses(profiled):
    """JAX writes an XProf directory; the port a Chrome trace that
    parses, with the CPU work of the capture in it."""
    trace_dir, _ = profiled["jax"]
    assert os.path.isdir(trace_dir)
    for suffix in ("", "-deadline"):
        path = os.path.join(profiled["port"][0] + suffix, "trace.json")
        with open(path) as f:
            trace = json.load(f)
        assert isinstance(trace["traceEvents"], list)


def test_profiler_on_the_card_refuses_without_cuda():
    """An App built for the card does not trace the CPU in its place."""
    import torch

    from gofr_tpu_torch import profiler

    if torch.cuda.is_available():
        pytest.skip("the card is there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.activities_for("cuda")
    assert [a.name for a in profiler.activities_for("cpu")] == ["CPU"]


# -- clusterz over canned probes ------------------------------------------------

STATUSZ_PROBE = {
    "slo": {"60s": {"goodput_tokens_per_s": 12.5}},
    "engine": {"kv_cache": {"occupancy": 0.25}, "queue_depth": 3},
    "watchdog": {"state": "DEGRADED", "reason": "ttft"},
    "slo_budget": {"budgets": [
        {"burn": {"5m": 2.0, "1h": None}, "budget_remaining": 0.5},
        {"burn": {"5m": 16.0}, "budget_remaining": 0.1}],
        "burning": ["generate/interactive"]},
}
INPROC_PROBE = {"stats": {"kv_pool": {"occupancy": 0.5}, "active_slots": 2,
                          "queue_depth": 1,
                          "device_seconds": {"generate/batch": 1.5}},
                "slo": {"60s": {"goodput_tokens_per_s": 3.0}},
                "health": "UP"}
OBSERVATIONS = [
    {}, INPROC_PROBE, {"kind": "http", "statusz": STATUSZ_PROBE,
                       "health": "UP"},
    {"statusz": {"engine": {"active_slots": 4}}, "slo_budget": {
        "budgets": [{"burn": {}, "budget_remaining": None}]}},
]


def test_extract_view_as_jax():
    from gofr_tpu.clusterz import _extract_view as jax_view
    from gofr_tpu_torch.clusterz import _extract_view as port_view

    for observation in OBSERVATIONS:
        assert port_view(observation) == jax_view(observation)


class _Canned:
    """A transport with a canned probe: ``mode`` is ``fresh``, ``open``
    (circuit open), ``raises`` or ``none`` (no ``observe``)."""

    def __init__(self, kind, observation, mode="fresh"):
        self.kind = kind
        self.observation = observation
        self.mode = mode
        if mode == "none":
            self.observe = None

    def available(self):
        return self.mode != "open"

    async def observe(self):
        if self.mode == "raises":
            raise ConnectionError("peer gone")
        return dict(self.observation)

    def describe(self):
        return {"kind": self.kind}

    def health_check(self):
        return {"status": "UP"}


def _canned_cluster(side):
    if side == "jax":
        from gofr_tpu.clusterz import build_clusterz
        from gofr_tpu.tpu.cluster import ClusterRegistry
    else:
        from gofr_tpu_torch.clusterz import build_clusterz
        from gofr_tpu_torch.tpu.cluster import ClusterRegistry
    cluster = ClusterRegistry()
    cluster.register("p0", "prefill", _Canned("inproc", INPROC_PROBE))
    cluster.register("p1", "prefill", _Canned("http", {
        "kind": "http", "statusz": STATUSZ_PROBE, "health": "UP"}))
    cluster.register("d0", "decode", _Canned("http", {}, mode="open"))
    cluster.register("d1", "decode", _Canned("http", {}, mode="raises"))
    cluster.register("d2", "decode", _Canned("inproc", INPROC_PROBE))
    cluster.register("b0", "both", _Canned("inproc", {}, mode="none"))
    cluster._replicas["d2"].state = "DRAINING"
    cluster._replicas["d2"].inflight = 1
    page = asyncio.run(build_clusterz(cluster))
    page.pop("at")
    return page


def test_build_clusterz_over_canned_probes_as_jax():
    """Fresh, draining, circuit-open, failing and unobservable replicas:
    the port's rollup is JAX's, stale where JAX's is, with its reasons."""
    got = {side: _canned_cluster(side) for side in SIDES}
    assert got["port"] == got["jax"]
    replicas = got["port"]["replicas"]
    assert replicas["d0"]["stale_reason"] == "circuit open"
    assert replicas["d1"]["stale"] and "peer gone" in replicas["d1"][
        "stale_reason"]
    assert replicas["p1"]["goodput_tokens_per_s"] == 12.5
    assert got["port"]["roles"]["prefill"]["goodput_tokens_per_s"] == 15.5


def test_build_tracez_falls_back_to_local_records_as_jax(served):
    """With no router (or ``local_only``) the page answers the local
    flight records of the trace id; an unknown id, none."""
    from gofr_tpu.clusterz import build_tracez as jax_tracez
    from gofr_tpu_torch.clusterz import build_tracez as port_tracez

    builders = {"jax": jax_tracez, "port": port_tracez}
    for side in SIDES:
        container = served["apps"][side].container
        tid = served["trace_ids"][side][1]
        page = asyncio.run(builders[side](container, tid, local_only=True))
        assert page["stitched"] is False and page["trace_id"] == tid
        assert [r["trace_id"] for r in page["records"]] == [tid]
        none = asyncio.run(builders[side](container, "0" * 32))
        assert none == {"trace_id": "0" * 32, "stitched": False,
                        "records": []}
