"""Port parity for the engine's telemetry hooks against the JAX package on
the CPU (``tiny``, float32).

The same seeded burst (4 requests, one sampled, each under its own
request span) goes through the JAX engine and the port's, dense and
paged, plain and speculative, each with its own package's ``Manager``
(the app's catalog registered), ``Tracer(ListExporter)``, ``SLOTracker``
and ``FlightRecorder``. They must give equal tokens, the same set of
``(metric, labels)`` emitted and equal values of every counter, gauge
and histogram count that does not measure time, the same multiset of
span names per request and of engine-step spans, and the same flight
records. The views ``statusz``, ``xlaz``, ``hbm_attribution`` and
``health_check`` must have JAX's key tree; each exception is listed
below with its reason. Every ``app_*`` name the port passes to a metrics
call must be in the app's catalog (``docs/quick-start/observability.md``)
and registered there with the kind the port's catalog gives it.
"""

import ast
import asyncio
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.slo import SLOTracker as JaxSLOTracker
from gofr_tpu.tpu.flightrecorder import FlightRecorder as JaxRecorder
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generate import Sampling as JaxSampling
from gofr_tpu.trace import ListExporter as JaxListExporter
from gofr_tpu.trace import Tracer as JaxTracer
from gofr_tpu_torch.metrics import (ENGINE_METRICS, Manager,
                                    register_engine_metrics)
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling
from gofr_tpu_torch.trace import ListExporter, Tracer

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]]
BUDGET = 10
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CASES = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4),
         "dense_spec": dict(spec=True),
         "paged_spec": dict(paged_kv=True, kv_page=4, spec=True)}
# metrics whose values are seconds: their label sets are compared, not
# their values
TIMED = {"app_tpu_device_seconds_total",
         "app_tpu_executable_device_seconds_total"}
# series the JAX engine emits and the port does not, with the reason
JAX_ONLY = {
    # the JAX engine counts jit-cache misses on every backend; the port
    # counts graph captures (ticks and prefill rungs), which only the card
    # makes
    ("app_tpu_engine_compiles_total",
     (("cls", "serving"), ("model", "generate"))),
}
# metered uploads: the same series (path dispatch and mask) as JAX's, but
# not the same transfers: JAX uploads a prefill group array by array
# (int32 tokens, slots, lengths, ...), the port a prefill rung's two
# packed buffers and a paged tick's whole table; their label sets are
# compared, and their totals against the port's own data_plane()
LABELS_ONLY = {"app_tpu_h2d_bytes_total", "app_tpu_h2d_seconds"}
# the paged JAX engine on the CPU attends through the gather formulation
# (its ragged kernel runs only compiled); the port's paged ticks read the
# pool through the ragged kernel (its plain version on the CPU)
PAGED_PATH = {"jax": ("app_tpu_attn_kernel_total",
                      (("model", "generate"), ("path", "gather"))),
              "port": ("app_tpu_attn_kernel_total",
                       (("model", "generate"), ("path", "ragged")))}
# key-tree exceptions of the views: path prefix -> reason
VIEW_EXCEPTIONS = {
    "/stats/": "stats() is the port's own: graphs and ticks in place of "
               "JAX's jit and mesh counters (its handoff counters are "
               "JAX's, STATS_KEYS)",
    "/details/": "health_check's details are stats()",
}
# keys of JAX's stats() the port's carries too, with JAX's meaning: the
# ones the telemetry plane reads and the disaggregated handoff's counters
STATS_KEYS = ("device_seconds", "compiles", "classes", "model",
              "free_slots", "queue_depth", "kv_exports", "kv_adoptions",
              "session_exports", "session_adoptions")
# operating-point keys whose values differ from JAX's, with the reason
OP_POINT_VALUES_APART = {
    "applied_at": "a monotonic instant of each process",
    "staging_depth": "the port's staging rings are max_inflight_ticks + 1 "
                     "deep (a pipelined tick's slabs), JAX's 1",
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _series(manager):
    """{(name, labels): value} of every ``app_tpu_*`` series (the mock
    container's other parts write their own, on their own clock); a
    histogram's count."""
    out = {}
    for name, metric in manager.snapshot().items():
        if not name.startswith("app_tpu_"):
            continue
        for key, value in metric.series.items():
            out[name, key] = (value["count"] if isinstance(value, dict)
                              else value)
    return out


async def _burst(engine, tracer, sampling):
    """The seeded burst, each request under its own span; returns the
    tokens and each request's trace id."""
    async def one(i, prompt):
        with tracer.start_span(f"request-{i}") as span:
            out = await engine.generate(
                prompt, BUDGET,
                sampling=sampling(0.8, seed=3) if i == 3 else None)
        return out, span.trace_id

    await engine.start()
    try:
        return await asyncio.wait_for(asyncio.gather(
            *[one(i, p) for i, p in enumerate(PROMPTS)]), 120.0)
    finally:
        await engine.stop()


def _spans_by_request(spans, trace_ids):
    per_request = [Counter(s.name for s in spans if s.trace_id == trace_id)
                   for trace_id in trace_ids]
    steps = Counter(s.name for s in spans if s.name.startswith("tpu."))
    unlinked = [s.name for s in spans
                if s.name.startswith("tpu.") and not s.links]
    return per_request, steps, unlinked


def _run(weights, case, package):
    kw = dict(CASES[case])
    spec = kw.pop("spec", False)
    if package == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        container = new_mock_container()
        metrics, exporter = container.metrics, JaxListExporter()
        tracer = JaxTracer(exporter=exporter)
        slo, recorder = JaxSLOTracker(metrics), JaxRecorder()
        if spec:
            kw.update(draft_cfg=jcfg, draft_params=weights, spec_gamma=4)
        engine = JaxEngine(jcfg, weights, logger=container.logger,
                           metrics=metrics, tracer=tracer, slo=slo,
                           recorder=recorder, **ENGINE_KW, **kw)
        sampling = JaxSampling
    else:
        tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
        params = from_jax_llama(weights, "cpu")
        metrics = register_engine_metrics(Manager())
        exporter = ListExporter()
        tracer = Tracer(exporter=exporter)
        slo, recorder = SLOTracker(metrics), FlightRecorder()
        if spec:
            kw.update(draft_cfg=tcfg, draft_params=params, spec_gamma=4)
        engine = GenerationEngine(tcfg, params, device="cpu",
                                  metrics=metrics, tracer=tracer, slo=slo,
                                  recorder=recorder, **ENGINE_KW, **kw)
        sampling = Sampling
    done = asyncio.run(_burst(engine, tracer, sampling))
    tracer.shutdown()
    tokens = [out for out, _ in done]
    return dict(engine=engine, tokens=tokens, series=_series(metrics),
                spans=_spans_by_request(exporter.spans,
                                        [t for _, t in done]),
                records=sorted(
                    (r["status"], r["prompt_len"], r["budget"], r["tokens"],
                     r["cached_prefix_len"], r["pages_held"],
                     r["batch_sizes"]["ticks"])
                    for r in recorder.snapshot()["recent"]),
                slo=slo)


@pytest.fixture(scope="module")
def bursts(weights):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = {pkg: _run(weights, case, pkg)
                           for pkg in ("jax", "port")}
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_hooked_tokens_equal_jax_and_unhooked(bursts, weights, case):
    runs = bursts(case)
    assert runs["port"]["tokens"] == runs["jax"]["tokens"]
    kw = dict(CASES[case])
    if kw.pop("spec", False):
        tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
        params = from_jax_llama(weights, "cpu")
        kw.update(draft_cfg=tcfg, draft_params=params, spec_gamma=4)
    else:
        tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
        params = from_jax_llama(weights, "cpu")
    bare = GenerationEngine(tcfg, params, device="cpu", **ENGINE_KW, **kw)
    unhooked = asyncio.run(_burst(bare, Tracer(), Sampling))
    assert [out for out, _ in unhooked] == runs["port"]["tokens"]


@pytest.mark.parametrize("case", list(CASES))
def test_emitted_metrics_as_jax(bursts, case):
    runs = bursts(case)
    jax_series, port_series = runs["jax"]["series"], runs["port"]["series"]
    jax_only = set(jax_series) - set(port_series)
    port_only = set(port_series) - set(jax_series)
    want_jax_only = set(JAX_ONLY)
    if CASES[case].get("paged_kv"):
        want_jax_only.add(PAGED_PATH["jax"])
        assert port_only == {PAGED_PATH["port"]}
        assert port_series[PAGED_PATH["port"]] \
            == jax_series[PAGED_PATH["jax"]]
    else:
        assert port_only == set()
    assert jax_only == want_jax_only
    for key in set(jax_series) & set(port_series):
        if key[0] not in TIMED | LABELS_ONLY and key[0] != "app_tpu_ttft":
            assert port_series[key] == jax_series[key], key
    plane = runs["port"]["engine"].data_plane()
    assert sum(v for (name, _), v in port_series.items()
               if name == "app_tpu_h2d_bytes_total") == plane["h2d_bytes"]
    assert sum(v for (name, _), v in port_series.items()
               if name == "app_tpu_h2d_seconds") == plane["h2d_uploads"]
    # histograms by count: one TTFT a request
    ttft = ("app_tpu_ttft", (("model", "generate"),))
    assert port_series[ttft] == jax_series[ttft] == len(PROMPTS)
    tokens = sum(len(t) for t in runs["port"]["tokens"])
    assert sum(v for (name, _), v in port_series.items()
               if name == "app_tpu_sched_tokens_total") == tokens
    assert runs["port"]["slo"].tokens.total() == tokens
    assert port_series["app_tpu_slo_total", (("outcome", "ok"),)] \
        == len(PROMPTS)
    if CASES[case].get("spec"):
        for name in ("app_tpu_spec_proposed_total",
                     "app_tpu_spec_accepted_total"):
            assert port_series[name, (("model", "generate"),)] \
                == jax_series[name, (("model", "generate"),)]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_per_request_as_jax(bursts, case):
    runs = bursts(case)
    per_request, steps, unlinked = runs["port"]["spans"]
    assert (per_request, steps) == runs["jax"]["spans"][:2]
    for i, names in enumerate(per_request):
        assert names == Counter({f"request-{i}": 1, "queue.wait": 1,
                                 "prefill": 1, "decode": 1})
    assert not unlinked and steps["tpu.engine.prefill"] >= 1


@pytest.mark.parametrize("case", list(CASES))
def test_flight_records_as_jax(bursts, case):
    runs = bursts(case)
    assert runs["port"]["records"] == runs["jax"]["records"]
    assert [r[0] for r in runs["port"]["records"]] == ["done"] * 4


@pytest.mark.parametrize("case", list(CASES))
def test_device_seconds_by_class_and_family_agree(bursts, case):
    engine = bursts(case)["port"]["engine"]
    by_class = sum(engine._device_seconds.values())
    assert by_class > 0
    assert abs(by_class - engine.exec_ledger.total_seconds()) < 1e-6
    families = {row["family"] for row in
                engine.exec_ledger.snapshot(limit=64)["top"]}
    jax_families = {row["family"] for row in
                    bursts(case)["jax"]["engine"].exec_ledger.snapshot(
                        limit=64)["top"]}
    assert families == jax_families


def _paths(tree, prefix=""):
    out = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            path = f"{prefix}/{key}"
            out.add(path)
            out |= _paths(value, path)
    return out


def _excepted(path):
    return any(path.startswith(prefix) for prefix in VIEW_EXCEPTIONS)


@pytest.mark.parametrize("view", ["statusz", "xlaz", "hbm_attribution",
                                  "health_check"])
@pytest.mark.parametrize("case", list(CASES))
def test_views_have_jax_key_tree(bursts, case, view):
    runs = bursts(case)
    jax_view = getattr(runs["jax"]["engine"], view)()
    port_view = getattr(runs["port"]["engine"], view)()
    jax_paths = {p for p in _paths(jax_view) if not _excepted(p)}
    port_paths = {p for p in _paths(port_view) if not _excepted(p)}
    assert port_paths == jax_paths
    if view == "statusz":
        assert set(port_view["data_plane"]["coalescer"]) \
            == set(jax_view["data_plane"]["coalescer"])
        assert port_view["data_plane"]["coalescer"]["transfers"] == 0
        for key in STATS_KEYS:
            assert key in port_view["stats"] and key in jax_view["stats"]
        for key in STATS_KEYS[-4:]:
            assert port_view["stats"][key] == jax_view["stats"][key] == 0
        assert port_view["requests"]["total_requests"] == len(PROMPTS)
    if view == "xlaz":
        port_point, jax_point = (
            {k: v for k, v in view_["operating_point"].items()
             if k not in OP_POINT_VALUES_APART}
            for view_ in (port_view, jax_view))
        assert port_point == jax_point
        assert port_view["operating_point"]["staging_depth"] \
            == runs["port"]["engine"].max_inflight_ticks + 1
        assert port_view["models"]["prompt"] == jax_view["models"]["prompt"]
    if view == "hbm_attribution":
        assert port_view["params_bytes"] == jax_view["params_bytes"]
        assert port_view["device_bytes_in_use"] is None
    if view == "health_check":
        assert port_view["status"] == jax_view["status"] == "UP"


def _metric_names_called():
    """(name, method, file) of every metrics call with a literal name in
    the port's package."""
    methods = {"increment_counter", "delta_updown_counter", "set_gauge",
               "record_histogram"}
    out = []
    for path in sorted((ROOT / "gofr_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in methods and node.args \
                    and isinstance(node.args[0], ast.Constant):
                out.append((node.args[0].value, node.func.attr,
                            str(path.relative_to(ROOT))))
    return out


KIND_OF_METHOD = {"increment_counter": "counter",
                  "delta_updown_counter": "updown_counter",
                  "set_gauge": "gauge", "record_histogram": "histogram"}


def test_every_metric_name_is_in_the_app_catalog():
    documented = set(re.findall(
        r"\bapp_[a-zA-Z0-9_]+\b",
        (ROOT / "docs/quick-start/observability.md").read_text()))
    calls = _metric_names_called()
    assert len({name for name, _, _ in calls}) >= 25
    catalog = {name: kind for name, kind, _, _ in ENGINE_METRICS}
    for name, method, path in calls:
        assert name in documented, (name, path)
        assert catalog.get(name) == KIND_OF_METHOD[method], (name, path)
    assert set(catalog) == {name for name, _, _ in calls}


def test_port_catalog_is_the_apps():
    jax_metrics = new_mock_container().metrics.snapshot()
    # the telemetry plane's series: the store's anomalies, the error-budget
    # plane's gauges, the traffic recorder's pulse, the sampler's spawner
    assert {"app_tpu_workload_events_total", "app_tpu_anomaly_total",
            "app_tpu_slo_burn_rate", "app_tpu_slo_budget_remaining",
            "app_async_task_failures_total"} \
        <= {name for name, _, _, _ in ENGINE_METRICS}
    # the fleet control plane's and the auto-tuner's series
    assert {"app_tpu_fleet_route_total", "app_tpu_fleet_affinity_pages",
            "app_tpu_fleet_migrations_total",
            "app_tpu_fleet_migration_seconds",
            "app_tpu_fleet_autoscale_total",
            "app_tpu_fleet_decode_replicas", "app_tpu_fleet_resume_total",
            "app_tpu_autotune_total", "app_tpu_autotune_score",
            "app_tpu_autotune_generation"} \
        <= {name for name, _, _, _ in ENGINE_METRICS}
    for name, kind, buckets, _ in ENGINE_METRICS:
        metric = jax_metrics[name]
        assert metric.kind == {"updown_counter": "updown"}.get(kind, kind)
        assert metric.buckets == list(buckets or [])


READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
         "__float__", "__index__", "__array__")


@pytest.mark.parametrize("case", ["dense", "paged_spec"])
def test_loop_thread_reads_no_tensor(weights, case, monkeypatch):
    """Every hook runs on the loop thread and reads host mirrors only:
    with every hook on and the anatomy sampled on every tick, the loop
    thread calls none of the tensor methods that read a device tensor
    back (each would be a sync on the card); the device thread does the
    fetches."""
    import threading

    loop_thread = threading.current_thread()
    reads = []
    for name in READS:
        original = getattr(torch.Tensor, name)

        def spy(self, *args, _name=name, _original=original, **kw):
            if threading.current_thread() is loop_thread:
                reads.append(_name)
            return _original(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    kw = dict(CASES[case])
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    params = from_jax_llama(weights, "cpu")
    if kw.pop("spec", False):
        kw.update(draft_cfg=tcfg, draft_params=params, spec_gamma=4)
    metrics = register_engine_metrics(Manager())
    tracer = Tracer(exporter=ListExporter())

    class Store:
        ticks = []

        def note_tick(self, entry):
            self.ticks.append(entry)

    engine = GenerationEngine(tcfg, params, device="cpu", metrics=metrics,
                              tracer=tracer, slo=SLOTracker(metrics),
                              recorder=FlightRecorder(), **ENGINE_KW, **kw)
    store = Store()
    engine.attach_telemetry(store, every=1)
    done = asyncio.run(_burst(engine, tracer, Sampling))
    tracer.shutdown()
    assert reads == []
    assert len(store.ticks) == engine.ticks + engine.spec_dispatches
    assert all(entry[key] >= 0 for entry in store.ticks
               for key in entry if key.endswith("_s"))
    assert sum(len(out) for out, _ in done) == len(PROMPTS) * BUDGET
