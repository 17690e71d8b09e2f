"""Guards on the port package: it imports nothing of JAX or of the JAX
package, and it never moves on to the CPU by itself — an entry point
left at its default device on a host without CUDA raises."""

import ast
from pathlib import Path

import pytest
import torch

from gofr_tpu_torch import resolve_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import _build
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention)
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import PagePool

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
