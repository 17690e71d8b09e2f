"""Port parity for the executor on the CPU: ``gofr_tpu_torch.tpu.Executor``
against ``gofr_tpu.tpu.Executor`` on the same tiny models (ResNet
``tiny`` and BERT ``tiny`` at float32, weights converted from the JAX
pytree) and inputs (numpy, seeded).

Outputs agree within ``atol`` / ``rtol`` 1e-4 through bucket padding,
the oversized split, a pytree input (BERT's ``(ids, mask)``) and the
warm path (``dispatch_rows``); an unknown model raises ``KeyError``;
``warmup`` builds every bucket and the ledger counts one warmup compile
each, as JAX's; ``xlaz()``, ``saturation()``, ``health_check()`` and
``data_plane()`` have JAX's key trees. The executor's slab ring follows
JAX's (grow to depth, then wait on the oldest), and every metric it
emits is registered (a logger whose ``error`` raises). On the card a
failed capture raises, and the default device raises without CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import bert as jax_bert
from gofr_tpu.models import resnet as jax_resnet
from gofr_tpu.tpu import Executor as JaxExecutor
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import bert, resnet
from gofr_tpu_torch.models.convert import from_jax_bert, from_jax_resnet
from gofr_tpu_torch.tpu import Executor, new_executor
from gofr_tpu_torch.tpu.staging import StagingPool

TOL = dict(atol=1e-4, rtol=1e-4)
BUCKETS = (1, 2, 4)


class RaisingLogger:
    def error(self, message, *args):
        raise AssertionError(message % args if args else message)

    def __getattr__(self, name):
        return lambda *args, **kw: None


def port_metrics():
    return register_engine_metrics(Manager(logger=RaisingLogger()))


def _jax_layout(tree):
    """A port ResNet tree as JAX's numpy tree (OIHW -> HWIO kernels)."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_layout(v) for v in tree]
    if tree.ndim == 4:
        tree = tree.permute(2, 3, 1, 0)
    return np.ascontiguousarray(tree.numpy())


@pytest.fixture(scope="module")
def models():
    """(name, jax fn, jax params, port fn, port params, example maker)."""
    rcfg = jax_resnet.config("tiny", dtype=jnp.float32)
    trcfg = resnet.config("tiny", dtype=torch.float32)
    # the port's random weights in JAX's layout (HWIO kernels)
    rparams = _jax_layout(resnet.init(trcfg, 0, device="cpu"))
    bcfg = jax_bert.config("tiny", dtype=jnp.float32, max_len=16)
    bparams = jax_bert.init(bcfg, jax.random.PRNGKey(1))
    tbcfg = bert.config("tiny", dtype=torch.float32, max_len=16)
    rng = np.random.default_rng(0)

    def images(n):
        return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)

    def pairs(n):
        ids = rng.integers(0, 256, size=(n, 16)).astype(np.int32)
        mask = np.zeros((n, 16), np.int32)
        for row in range(n):
            mask[row, :rng.integers(1, 17)] = 1
        return ids, mask

    def jbert(p, inputs):
        ids, mask = inputs
        return jax_bert.apply(p, bcfg, ids, mask)["mean"]

    def tbert(p, inputs):
        ids, mask = inputs
        return bert.apply(p, tbcfg, ids, mask)["mean"]

    np_b = jax.tree.map(np.asarray, bparams)
    return {
        "resnet": (lambda p, x: jax_resnet.apply(p, rcfg, x), rparams,
                   lambda p, x: resnet.apply(p, trcfg, x),
                   from_jax_resnet(rparams, "cpu"), images),
        "bert": (jbert, bparams, tbert, from_jax_bert(np_b, "cpu"), pairs),
    }


def _pair(models, name, staging=True):
    container = new_mock_container()
    jax_exec = JaxExecutor(container.logger, container.metrics,
                           staging=staging)
    port = Executor(None, port_metrics(), staging=staging, device="cpu")
    jfn, jparams, tfn, tparams, _ = models[name]
    jax_exec.register(name, jfn, jparams, buckets=BUCKETS)
    port.register(name, tfn, tparams, buckets=BUCKETS)
    return jax_exec, port


@pytest.mark.parametrize("staging", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_predict_pads_and_splits_as_jax(models, name, staging):
    jax_exec, port = _pair(models, name, staging)
    make = models[name][4]
    for n in (3, 4, 6):     # padded to 4; a bucket exactly; split 4 + 2
        batch = make(n)
        want = jax_exec.predict(name, batch)
        got = port.predict(name, batch)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert sorted(port._models[name].compiled) \
        == sorted(jax_exec._models[name].compiled) == [2, 4]
    assert port.ledger.total("serving") == jax_exec.ledger.total("serving")


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_dispatch_rows_is_predict(models, name):
    jax_exec, port = _pair(models, name)
    make = models[name][4]
    batch = make(3)
    rows = [jax.tree.map(lambda leaf: leaf[i], batch) for i in range(3)]
    want = port.predict(name, batch)
    assert port.is_warm(name, 3) and not port.is_warm(name, 1)
    got = port.fetch(port.dispatch_rows(name, rows))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, np.asarray(jax_exec.fetch(jax_exec.dispatch_rows(name, rows))),
        **TOL)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        port.dispatch(name, make(5))


def test_unknown_model_and_warmup_as_jax(models):
    jax_exec, port = _pair(models, "resnet")
    for executor in (jax_exec, port):
        with pytest.raises(KeyError):
            executor.predict("nope", np.ones((1, 2)))
        executor.warmup("resnet", models["resnet"][4](1)[0])
        assert sorted(executor._models["resnet"].compiled) == list(BUCKETS)
    assert port.ledger.total("warmup") == jax_exec.ledger.total("warmup") \
        == len(BUCKETS)
    assert port.ledger.total("serving") == 0
    event = port.ledger.snapshot()["recent"][0]
    assert set(event) == set(jax_exec.ledger.snapshot()["recent"][0])
    assert len(event["fingerprint"]) == 16


def _paths(tree, prefix=""):
    out = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            path = f"{prefix}/{key}"
            out.add(path)
            out |= _paths(value, path)
    return out


# subtrees keyed by data (device ids, model names, buckets, families):
# JAX's CPU backend here has eight virtual devices, the port one
KEYED = ("/hbm/", "/devices/", "/observed_batch_sizes/", "/bucket_hits/",
         "/slabs/")


def _tree(view):
    return {p for p in _paths(view)
            if not any(k in p and not p.endswith(k.rstrip("/"))
                       for k in KEYED)}


def test_views_have_jax_key_trees(models):
    jax_exec, port = _pair(models, "bert")
    batch = models["bert"][4](3)
    for executor in (jax_exec, port):
        executor.predict("bert", batch)
    for view in ("xlaz", "saturation", "health_check", "data_plane"):
        want, got = getattr(jax_exec, view)(), getattr(port, view)()
        assert _tree(got) == _tree(want), view
    sat = port.saturation()
    assert set(sat["hbm"]["0"]) == set(jax_exec.saturation()["hbm"]["0"])
    assert sat["flops_per_s"] > 0 and sat["duty_cycle"] > 0
    health = port.health_check()
    assert set(health["devices"]["0"]) \
        == set(jax_exec.health_check()["devices"]["0"])
    assert health["status"] == "UP" and health["compiling"] == []
    assert port.data_plane()["staging"]["slabs"] == {"('bert', 4)": 1}
    xlaz = port.xlaz()
    assert xlaz["models"]["bert"]["observed_batch_sizes"] == {"3": 1}
    assert xlaz["executables"]["top"][0]["family"] == "b4"


class _Pending:
    """A copy still in flight until ``synchronize``."""

    def __init__(self, name, waits):
        self.name, self.waits = name, waits

    def synchronize(self):
        self.waits.append(self.name)


def test_slab_ring_grows_to_depth_then_waits_as_jax():
    specs = [((4, 3), "float32"), ((4,), "int32")]
    waits = []
    pool = StagingPool(torch.device("cpu"), depth=2)
    first = pool.acquire("k", specs)
    pool.retire("k", first, _Pending("a", waits))
    second = pool.acquire("k", specs)
    assert second is not first and waits == []
    pool.retire("k", second, _Pending("b", waits))
    third = pool.acquire("k", specs)
    assert third is first and waits == ["a"]
    assert pool.stats()["slabs"] == {"k": 2}
    assert pool.stats()["reuse_waits"] == 1
    wider = pool.acquire("k", [((8, 3), "float32"), ((8,), "int32")])
    assert wider.buffers[0].shape == (8, 3)


def test_mesh_is_refused_and_the_card_is_the_default():
    class Config(dict):
        def get_float(self, key, default):
            return float(self.get(key, default))

    # TPU_MESH lays the executor over a mesh (ported); on the CPU over as
    # many CPU devices as it needs
    meshed = new_executor(Config(TPU_MESH="dp:2"), None, None, device="cpu")
    assert dict(meshed.mesh.shape) == {"dp": 2}
    executor = new_executor(Config(TPU_PEAK_FLOPS="1e12",
                                   EXEC_STAGING="0"), None, None,
                            device="cpu")
    assert executor.peak_flops == 1e12 and executor._staging is None
    with pytest.raises(ValueError, match="mesh"):
        Executor(None, None, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Executor(None, None)
