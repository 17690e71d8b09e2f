"""Guards on the port package: it imports nothing of JAX or of the JAX
package, and it never moves on to the CPU by itself — an entry point
left at its default device on a host without CUDA raises."""

import ast
from pathlib import Path

import pytest
import torch

from gofr_tpu_torch import resolve_device
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import _build
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention)
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import PagePool
from gofr_tpu_torch.tpu.prefix_cache import PrefixStore
from gofr_tpu_torch.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "gofr_tpu")
# the app framework's modules: each the port's own copy
APP_MODULES = [
    "gofr_tpu_torch/config/__init__.py", "gofr_tpu_torch/config/config.py",
    "gofr_tpu_torch/logging/__init__.py", "gofr_tpu_torch/logging/logger.py",
    "gofr_tpu_torch/metrics/exposition.py",
    "gofr_tpu_torch/datasource/file.py",
    "gofr_tpu_torch/http/__init__.py", "gofr_tpu_torch/http/errors.py",
    "gofr_tpu_torch/http/request.py", "gofr_tpu_torch/http/response.py",
    "gofr_tpu_torch/http/responder.py", "gofr_tpu_torch/http/router.py",
    "gofr_tpu_torch/http/server.py",
    "gofr_tpu_torch/http/middleware/__init__.py",
    "gofr_tpu_torch/http/middleware/tracer.py",
    "gofr_tpu_torch/http/middleware/logger.py",
    "gofr_tpu_torch/http/middleware/cors.py",
    "gofr_tpu_torch/http/middleware/metrics.py",
    "gofr_tpu_torch/http/middleware/basic_auth.py",
    "gofr_tpu_torch/http/middleware/apikey_auth.py",
    "gofr_tpu_torch/http/middleware/oauth.py",
    "gofr_tpu_torch/context.py", "gofr_tpu_torch/handler.py",
    "gofr_tpu_torch/container.py", "gofr_tpu_torch/cron.py",
    "gofr_tpu_torch/grpcx/__init__.py", "gofr_tpu_torch/grpcx/server.py",
    "gofr_tpu_torch/app.py", "gofr_tpu_torch/tokenizer.py",
    "gofr_tpu_torch/native/__init__.py",
    "gofr_tpu_torch/examples/__init__.py",
    "gofr_tpu_torch/examples/llama_generate.py",
]
# the debug pages, the outbound service layer and the profiler
DEBUG_MODULES = [
    "gofr_tpu_torch/service/__init__.py",
    "gofr_tpu_torch/service/client.py",
    "gofr_tpu_torch/service/options.py",
    "gofr_tpu_torch/service/circuit_breaker.py",
    "gofr_tpu_torch/profiler.py", "gofr_tpu_torch/statusz.py",
    "gofr_tpu_torch/varz.py", "gofr_tpu_torch/xlaz.py",
    "gofr_tpu_torch/timez.py", "gofr_tpu_torch/workloadz.py",
    "gofr_tpu_torch/sloz.py", "gofr_tpu_torch/whyz.py",
    "gofr_tpu_torch/tunez.py", "gofr_tpu_torch/clusterz.py",
]
# the datasources and the smoke's in-process brokers
DATASOURCE_MODULES = [
    "gofr_tpu_torch/datasource/pubsub/__init__.py",
    "gofr_tpu_torch/datasource/pubsub/kafka.py",
    "gofr_tpu_torch/datasource/pubsub/mqtt.py",
    "gofr_tpu_torch/datasource/pubsub/google.py",
    "gofr_tpu_torch/datasource/redisx/__init__.py",
    "gofr_tpu_torch/datasource/redisx/client.py",
    "gofr_tpu_torch/datasource/sql/__init__.py",
    "gofr_tpu_torch/datasource/sql/db.py",
    "gofr_tpu_torch/datasource/sql/query_builder.py",
    "gofr_tpu_torch/datasource/mongo.py",
    "gofr_tpu_torch/datasource/nosql.py",
    "gofr_tpu_torch/migration/__init__.py",
    "gofr_tpu_torch/migration/runner.py",
    "gofr_tpu_torch/logging/remote_level.py",
    "scripts/wire_brokers.py",
]
# the rest of the framework and the examples beside llama_generate
FRAMEWORK_REST_MODULES = [
    "gofr_tpu_torch/__init__.py", "gofr_tpu_torch/version.py",
    "gofr_tpu_torch/file_utils.py", "gofr_tpu_torch/testutil.py",
    "gofr_tpu_torch/crud.py", "gofr_tpu_torch/openapi.py",
    "gofr_tpu_torch/cli/__init__.py", "gofr_tpu_torch/cli/command.py",
    "gofr_tpu_torch/cli/runner.py",
    "gofr_tpu_torch/websocket/__init__.py",
    "gofr_tpu_torch/websocket/frames.py",
    "gofr_tpu_torch/websocket/connection.py",
    "gofr_tpu_torch/websocket/upgrade.py",
] + [f"gofr_tpu_torch/examples/{name}.py" for name in (
    "http_server", "grpc_server", "using_subscriber", "cmd",
    "websocket_chat", "http_server_using_redis", "using_add_rest_handlers",
    "using_migrations", "using_file_bind", "using_http_service",
    "using_publisher", "using_custom_metrics", "using_cron")]


def _port_files():
    files = sorted((ROOT / "gofr_tpu_torch").rglob("*.py"))
    return files + [ROOT / "scripts" / "wire_brokers.py",
                    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    offenders = [(str(path.relative_to(ROOT)), root)
                 for path in files for root in _imported_roots(path)
                 if root in FORBIDDEN]
    assert offenders == []


def test_guard_scans_the_admission_and_grammar_modules():
    """The host modules the port copied from the JAX package (none of
    which imports JAX there) are scanned like the rest: each is the port's
    own file and imports nothing of the JAX package. So are the telemetry
    plane's copies (metrics, tracing, flight recorder, faults, the
    executable ledger), and the telemetry plane's memory and judgment
    (the time-series store, the error-budget plane, the workload
    recorder, the diagnosis, ``hbm_occupancy``, the task spawner), and
    the disaggregated path's (the KV wire codec, the retry policy, the
    model registry, the cluster), and the fleet control plane and the
    operating-point auto-tuner, and training (the train step and the
    checkpoints), and the app framework (:data:`APP_MODULES`), and the
    debug pages, the outbound service layer and the profiler
    (:data:`DEBUG_MODULES`), and the datasources with the smoke's
    in-process brokers (:data:`DATASOURCE_MODULES`), and the rest of the
    framework with the examples (:data:`FRAMEWORK_REST_MODULES`)."""
    files = {str(path.relative_to(ROOT)) for path in _port_files()}
    own = ["gofr_tpu_torch/slo.py", "gofr_tpu_torch/tpu/constrain.py",
           "gofr_tpu_torch/tpu/sched.py",
           "gofr_tpu_torch/metrics/__init__.py",
           "gofr_tpu_torch/metrics/catalog.py",
           "gofr_tpu_torch/metrics/digest.py",
           "gofr_tpu_torch/metrics/manager.py",
           "gofr_tpu_torch/trace/__init__.py",
           "gofr_tpu_torch/trace/tracer.py",
           "gofr_tpu_torch/tpu/flightrecorder.py",
           "gofr_tpu_torch/tpu/faults.py",
           "gofr_tpu_torch/tpu/compile_ledger.py",
           "gofr_tpu_torch/metrics/timeseries.py",
           "gofr_tpu_torch/slo_budget.py",
           "gofr_tpu_torch/tpu/workload.py",
           "gofr_tpu_torch/tpu/diagnose.py",
           "gofr_tpu_torch/hbmz.py",
           "gofr_tpu_torch/aio.py",
           "gofr_tpu_torch/tpu/kv_wire.py",
           "gofr_tpu_torch/tpu/retry.py",
           "gofr_tpu_torch/tpu/registry.py",
           "gofr_tpu_torch/tpu/cluster.py",
           "gofr_tpu_torch/tpu/fleet.py",
           "gofr_tpu_torch/tpu/autotune.py",
           "gofr_tpu_torch/tpu/capture.py",
           "gofr_tpu_torch/tpu/executor.py",
           "gofr_tpu_torch/tpu/batcher.py",
           "gofr_tpu_torch/tpu/batch_lane.py",
           "gofr_tpu_torch/models/resnet.py",
           "gofr_tpu_torch/models/bert.py",
           "gofr_tpu_torch/datasource/__init__.py",
           "gofr_tpu_torch/datasource/pubsub/base.py",
           "gofr_tpu_torch/datasource/pubsub/inmem.py",
           "gofr_tpu_torch/parallel/__init__.py",
           "gofr_tpu_torch/parallel/train.py",
           "gofr_tpu_torch/utils/__init__.py",
           "gofr_tpu_torch/utils/checkpoint.py",
           "gofr_tpu_torch/utils/tree.py"] + APP_MODULES + DEBUG_MODULES \
        + DATASOURCE_MODULES + FRAMEWORK_REST_MODULES
    assert set(own) <= files
    for name in own + ["gofr_tpu_torch/tpu/generate.py"]:
        assert not set(_imported_roots(ROOT / name)) & set(FORBIDDEN), name


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable on this host")


def test_default_device_raises_without_cuda(no_cuda):
    cfg = llama.config("tiny", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagePool(cfg, page=4, num_pages=8)
    params = llama.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(cfg, params, max_len=64, prompt_buckets=(8,),
                         kv_page=4)
    # with every telemetry hook, the engine at its default device raises
    # the same way
    metrics = register_engine_metrics(Manager())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(cfg, params, max_len=64, prompt_buckets=(8,),
                         metrics=metrics, tracer=Tracer(),
                         slo=SLOTracker(metrics), recorder=FlightRecorder())


def test_prefix_store_default_device_raises_without_cuda(no_cuda):
    cfg = llama.config("tiny", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefixStore(cfg, page=4, num_pages=8)
    assert PrefixStore(cfg, page=4, num_pages=8, device="cpu").pool[
        "k"].device.type == "cpu"


def test_kernel_build_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        _build.load("flash_attention")
    with pytest.raises(RuntimeError):
        _build.load("ragged_paged_attention")


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 4, 2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ragged_paged_decode_attention(q[:, :1], q, q, q, q, q, q)


def test_library_path_is_keyed_by_source():
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("flash_attention-")
    assert path == _build.library_path("flash_attention")
    assert path != _build.library_path("ragged_paged_attention")


def test_moe_and_engine_arguments_default_to_the_card(no_cuda):
    """The MoE module's entry points and an engine built as the app builds
    it (a shared pool, ``kv_pool_bytes``, the MoE module) raise at their
    default device; the MoE module is scanned like every port module."""
    from gofr_tpu_torch.models import moe

    assert "gofr_tpu_torch/models/moe.py" in {
        str(p.relative_to(ROOT)) for p in _port_files()}
    cfg = moe.config(base=llama.config("tiny", dtype=torch.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe.init_cache(cfg, 1, 8)
    params = moe.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(cfg, params, max_len=64, prompt_buckets=(8,),
                         model_module=moe)
    lcfg = llama.config("tiny", dtype=torch.float32)
    lparams = llama.init(lcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(lcfg, lparams, max_len=64, prompt_buckets=(8,),
                         paged_kv=True, kv_page=4, kv_pool_bytes=1 << 20)
    pool = PagePool(lcfg, page=4, num_pages=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(lcfg, lparams, max_len=64, prompt_buckets=(8,),
                         paged_kv=True, kv_page=4, page_pool=pool)


def test_executor_path_defaults_to_the_card(no_cuda):
    """The executor path's entry points (the executor, its factory, the
    ResNet and BERT modules and their converters) raise at their default
    device; the CPU runs only when asked for."""
    import numpy as np

    from gofr_tpu_torch.models import bert, resnet
    from gofr_tpu_torch.models.convert import from_jax_bert, from_jax_resnet
    from gofr_tpu_torch.tpu import Executor, new_executor

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor(None, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        new_executor(None, None, None)
    for module in (resnet, bert):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.init(module.config("tiny"))
    for convert in (from_jax_resnet, from_jax_bert):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert({"w": np.zeros((1, 1, 1, 1), np.float32)})
    assert Executor(None, None, device="cpu").device.type == "cpu"


def test_training_entry_points_default_to_the_card(no_cuda, tmp_path):
    """The train and eval steps, the checkpoint restore and the train
    state converter raise at their default device; the CPU runs only when
    asked for."""
    from gofr_tpu_torch.models.convert import from_jax_train_state
    from gofr_tpu_torch.parallel import make_eval_step, make_train_step
    from gofr_tpu_torch.utils import restore_checkpoint, save_checkpoint

    cfg = llama.config("tiny", dtype=torch.float32)
    for make in (make_train_step, make_eval_step):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(cfg)
    init_fn, _ = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    save_checkpoint(str(tmp_path), state, step=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(str(tmp_path), state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_train_state(state)
    assert restore_checkpoint(str(tmp_path), state, device="cpu").step \
        .device.type == "cpu"


# the example's knobs, and datasources another test's example may have
# left in the environment (the port refuses those it lacks)
APP_ENV_UNSET = ("MODELS", "MESH", "TPU_MESH", "CLUSTER_PEERS",
                 "GENERATE_DRAFT_MODEL", "BATCH_LANE_TOPIC", "PUBSUB_BACKEND",
                 "DB_DIALECT", "REDIS_HOST", "MONGO_URI", "CASSANDRA_HOSTS",
                 "CLICKHOUSE_HOST", "REMOTE_LOG_URL", "TPU_ENABLED")


def test_app_entry_points_default_to_the_card(no_cuda, monkeypatch):
    """The example's ``build_app()``, an app's container and the executor
    its ``add_model`` builds default to the card and raise without CUDA;
    the CPU runs only when asked for. The native tokenizer's source ships
    with the package, its library is built under ``build/``."""
    from gofr_tpu_torch.app import App, new_app
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.examples import llama_generate

    assert (ROOT / "gofr_tpu_torch/native/tokenizer.cpp").exists()
    for key in APP_ENV_UNSET:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LLAMA_PRESET", "tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_generate.build_app()
    app = App(config=MapConfig({}))
    assert app.container.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.add_model("m", lambda p, x: x, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Container.create(MapConfig({"TPU_ENABLED": "1"}))
    assert new_app().container.device == "cuda"
    cpu = App(config=MapConfig({}), device="cpu")
    cpu.add_model("m", lambda p, x: x, {})
    assert cpu.container.tpu.device.type == "cpu"


MODEL_EXAMPLES = [("http_server", "RESNET_PRESET"),
                  ("grpc_server", "BERT_PRESET"),
                  ("using_subscriber", "RESNET_PRESET")]


@pytest.mark.parametrize("name,preset", MODEL_EXAMPLES)
def test_model_examples_default_to_the_card(no_cuda, monkeypatch, name,
                                            preset):
    """Each model example's ``build_app()`` raises without CUDA;
    ``device="cpu"`` builds it."""
    import importlib

    module = importlib.import_module(f"gofr_tpu_torch.examples.{name}")
    for key in APP_ENV_UNSET:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv(preset, "tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.build_app()
    app = module.build_app(device="cpu")
    assert app.container.device.type == "cpu"
    assert app.container.tpu.device.type == "cpu"


def test_cli_entry_points_default_to_the_card(no_cuda):
    """``new_cmd()`` builds on the card as ``new_app()`` does; the ``cmd``
    example's ``classify`` raises without CUDA (the command fails, exit
    code 1) and runs on ``device="cpu"``."""
    import io

    from gofr_tpu_torch import new_cmd
    from gofr_tpu_torch.cli import run_cli
    from gofr_tpu_torch.examples import cmd

    assert new_cmd().container.device == "cuda"
    assert cmd.app.container.device == "cuda"
    err = io.StringIO()
    assert run_cli(cmd.app, ["classify"], stdout=io.StringIO(),
                   stderr=err) == 1
    assert "CUDA is not available" in err.getvalue()
    out = io.StringIO()
    assert run_cli(cmd.build_app(device="cpu"), ["classify"],
                   stdout=out) == 0
    assert "label" in out.getvalue()


@pytest.mark.parametrize("env,match", [
    ({"MESH": "tp:8"}, "needs 8 devices, have 1"),
    ({"TPU_MESH": "dp:1,tp:2"}, "needs 2 devices, have 1"),
    ({"CLUSTER_PEERS": "b=decode@http://h:1"}, "CLUSTER_PEERS")])
def test_example_refuses_knobs_not_ported(monkeypatch, env, match):
    """``MESH`` / ``TPU_MESH`` are served over ``parallel/mesh.
    device_mesh``: on the card over the visible cards, so with one card a
    mesh needing more raises JAX's "needs N devices" at build; on the CPU
    over as many CPU devices as the spec needs, where tp 8 is refused by
    the engine (tp must divide tiny's 4 heads) and tp 2 serves.
    ``CLUSTER_PEERS`` is served (its peers behind ``HTTPTransport``s), and
    a malformed entry raises as JAX's ``parse_peers`` does."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.parallel import mesh as mesh_mod

    for key in APP_ENV_UNSET:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LLAMA_PRESET", "tiny")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if match == "CLUSTER_PEERS":
        from gofr_tpu_torch.tpu.cluster import HTTPTransport
        cluster = llama_generate.build_app(device="cpu").container.cluster
        peer = cluster._replicas["b"]
        assert (peer.role, type(peer.transport)) == ("decode", HTTPTransport)
        assert peer.transport.describe() == {
            "kind": "http", "base_url": "http://h:1", "grpc_target": None,
            "circuit": "closed"}
        monkeypatch.setenv("CLUSTER_PEERS", "b=decode")
        with pytest.raises(ValueError, match=match):
            llama_generate.build_app(device="cpu")
    else:
        card = torch.device("cuda", 0)
        monkeypatch.setattr(mesh_mod, "visible_devices", lambda: [card])
        with pytest.raises(ValueError, match=match):
            llama_generate.mesh_from_config(MapConfig(env), card)
        if "MESH" in env:
            with pytest.raises(ValueError, match="tp 8 does not divide"):
                llama_generate.build_app(device="cpu")
        else:
            app = llama_generate.build_app(device="cpu")
            assert app.engine.stats()["mesh"] == {"dp": 1, "tp": 2}
    monkeypatch.setenv("MESH", "off")
    monkeypatch.delenv("TPU_MESH", raising=False)
    monkeypatch.delenv("CLUSTER_PEERS", raising=False)
    assert llama_generate.build_app(device="cpu").engine.device.type == "cpu"


def test_profiler_on_an_app_for_the_card_raises_without_cuda(no_cuda):
    """``POST /debug/profiler/start`` on an App built for the card fails
    where CUDA is unavailable (500, nothing captured): it never traces
    the CPU in the card's place."""
    import asyncio
    import json

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    app = App(config=MapConfig({"LOG_LEVEL": "FATAL"}))
    app.enable_profiler()
    app.http_port = app.metrics_port = 0

    async def main():
        await app.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", app.bound_http_port)
            writer.write(b"POST /debug/profiler/start HTTP/1.1\r\nHost: x"
                         b"\r\nContent-Length: 2\r\nConnection: close"
                         b"\r\n\r\n{}")
            await writer.drain()
            raw = await reader.read()
            writer.close()
            return raw
        finally:
            await app.stop()

    raw = asyncio.run(main())
    assert raw.split()[1] == b"500"
    assert json.loads(raw.partition(b"\r\n\r\n")[2])["error"]
    assert app._profiler_state["dir"] is None
    assert app._profiler_state["captures"] == 0
