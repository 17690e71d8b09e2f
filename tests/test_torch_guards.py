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


def _port_files():
    files = sorted((ROOT / "gofr_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


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
    checkpoints)."""
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
           "gofr_tpu_torch/utils/tree.py"]
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
