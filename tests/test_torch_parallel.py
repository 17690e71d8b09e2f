"""Port parity for ``parallel/``: meshes, spec trees, sharded leaves,
collectives, ring attention, the pipeline, ``llama.forward(mesh=)`` and
the multi-process runtime, each against the JAX package on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port's
mesh of the same shape lists that many ``torch.device("cpu")`` entries.
Every shard the port holds at a mesh coordinate is compared, bit for
bit, with the shard JAX holds on the device at that coordinate
(``addressable_shards``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.ops import attention as jax_attention
from gofr_tpu.ops import prefill_attention as jax_prefill_attention
from gofr_tpu.ops.quant import quantized_specs as jax_quantized_specs
from gofr_tpu.parallel import mesh as jax_mesh_mod
from gofr_tpu.parallel import sharding as jax_sharding
from gofr_tpu.parallel.pipeline import make_pp_forward as jax_pp_forward
from gofr_tpu.parallel.ring_attention import ring_attention as jax_ring
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops.quant import quantized_specs
from gofr_tpu_torch.parallel import collectives, multihost
from gofr_tpu_torch.parallel import sharding as pt_sharding
from gofr_tpu_torch.parallel.mesh import (make_mesh, parse_mesh_spec,
                                          serving_mesh)
from gofr_tpu_torch.parallel.pipeline import make_pp_forward
from gofr_tpu_torch.parallel.ring_attention import ring_attention

CPU8 = [torch.device("cpu")] * 8


def _np(x):
    """A tensor or JAX array as numpy; bf16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _spec_tree(tree):
    """A spec tree (JAX's or the port's) as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {key: _spec_tree(val) for key, val in tree.items()}
    return tuple(tree)


# -- meshes ------------------------------------------------------------------
def test_make_mesh_shapes_and_errors_match_jax():
    """tests/test_parallel.py:21-28 on both packages."""
    for axes in ({"dp": 2, "tp": 4}, {"dp": -1, "tp": 2}, {"sp": 4},
                 None):
        want = jax_mesh_mod.make_mesh(axes)
        got = make_mesh(axes, CPU8)
        assert dict(got.shape) == dict(want.shape)
        assert got.axis_names == want.axis_names
    assert dict(serving_mesh(tp=4, devices=CPU8).shape) == dict(
        jax_mesh_mod.serving_mesh(tp=4).shape) == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError) as want:
        jax_mesh_mod.make_mesh({"dp": 16})
    with pytest.raises(ValueError) as got:
        make_mesh({"dp": 16}, CPU8)
    assert str(got.value) == str(want.value)
    # a device may repeat: tp 2 over one device
    assert make_mesh({"tp": 2}, [torch.device("cpu")] * 2).distinct_devices \
        == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh({"dp": 1})


@pytest.mark.parametrize("spec", [
    None, "", "  ", "auto", "AUTO", "8", "tp:4", "dp:2,tp:4", "tp:2,dp:4",
    "dp:2, tp:4,", "sp:8", "tp", "dp:2,tp", ":4", "tp:x", "dp:2,tp:4.5"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_mesh_mod.parse_mesh_spec(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(err)
        return
    assert parse_mesh_spec(spec) == want


# -- spec trees ----------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs", [
    ("llama_param_specs", {}), ("llama_param_specs", {"tp": "model"}),
    ("llama_cache_specs", {}), ("llama_cache_specs", {"kv_int8": True}),
    ("llama_prefix_pool_specs", {}),
    ("llama_prefix_pool_specs", {"kv_int8": True}),
    ("moe_param_specs", {}), ("bert_param_specs", {})])
def test_spec_trees_match_jax(name, kwargs):
    want = getattr(jax_sharding, name)(**kwargs)
    got = getattr(pt_sharding, name)(**kwargs)
    assert _spec_tree(got) == _spec_tree(want)


def test_prune_batch_and_quantized_specs_match_jax():
    jmesh = jax_mesh_mod.make_mesh({"dp": 2, "tp": 4})
    pmesh = make_mesh({"dp": 2, "tp": 4}, CPU8)
    smesh = jax_mesh_mod.make_mesh({"sp": 8})
    for jm, pm in ((jmesh, pmesh),
                   (smesh, make_mesh({"sp": 8}, CPU8))):
        assert _spec_tree(pt_sharding.prune_specs(
            pt_sharding.llama_param_specs(), pm)) == _spec_tree(
            jax_sharding.prune_specs(jax_sharding.llama_param_specs(), jm))
    assert tuple(pt_sharding.batch_spec(ndim=3)) == tuple(
        jax_sharding.batch_spec(ndim=3))
    cfg = jax_llama.config("tiny")
    qparams = jax_llama.quantize_params(jax_llama.init(
        cfg, jax.random.PRNGKey(0)))
    tparams = from_jax_llama(jax.tree.map(np.asarray, qparams), "cpu")
    want = jax_quantized_specs(jax_sharding.llama_param_specs(), qparams)
    got = quantized_specs(pt_sharding.llama_param_specs(), tparams)
    assert _spec_tree(got) == _spec_tree(want)
    flat = pt_sharding.replicated_specs({"a": torch.zeros(2), "b": {
        "c": torch.zeros(3)}})
    assert _spec_tree(flat) == {"a": (), "b": {"c": ()}}


# -- sharded leaves ------------------------------------------------------------
def _coords(jmesh):
    """JAX device id → mesh coordinate."""
    return {jmesh.devices[c].id: c for c in np.ndindex(jmesh.devices.shape)}


def _assert_same_shards(jtree, ptree, jmesh):
    coords = _coords(jmesh)
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    for path, jleaf in jleaves:
        node = ptree
        for key in path:
            node = node[key.key]
        assert isinstance(node, pt_sharding.Sharded), path
        assert node.shape == tuple(jleaf.shape)
        assert len(jleaf.addressable_shards) == node.shards.size
        for shard in jleaf.addressable_shards:
            got = node.shard(coords[shard.device.id])
            np.testing.assert_array_equal(_np(got), _np(shard.data),
                                          err_msg=str(path))


@pytest.mark.parametrize("case", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 4}, {"dp": 4, "tp": 2}])
def test_shard_pytree_shards_equal_jax_addressable_shards(case, axes):
    dtype = jnp.float32 if case == "f32" else jnp.bfloat16
    cfg = jax_llama.config("tiny", dtype=dtype, n_heads=8, n_kv_heads=4)
    jparams = jax_llama.init(cfg, jax.random.PRNGKey(3))
    if case == "int8":
        jparams = jax_llama.quantize_params(jparams)
    jmesh = jax_mesh_mod.make_mesh(axes)
    pmesh = make_mesh(axes, CPU8)
    jspecs = jax_sharding.prune_specs(jax_quantized_specs(
        jax_sharding.llama_param_specs(), jparams), jmesh)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    pspecs = pt_sharding.prune_specs(quantized_specs(
        pt_sharding.llama_param_specs(), tparams), pmesh)
    jsharded = jax_sharding.shard_pytree(jparams, jmesh, jspecs)
    psharded = pt_sharding.shard_pytree(tparams, pmesh, pspecs)
    _assert_same_shards(jsharded, psharded, jmesh)
    # the full leaves come back
    full = pt_sharding.gather_pytree(psharded)
    for key in ("tok_emb", "lm_head"):
        a, b = full[key], tparams[key]
        a, b = (a["q"], b["q"]) if isinstance(a, dict) else (a, b)
        assert torch.equal(a, b)


def test_shard_pytree_holds_one_copy_a_device():
    """Coordinates on one device share the tensor of a slice they both
    hold: a replicated leaf on its own device is the caller's tensor, a
    tp rank's slice is one tensor for every dp row, and the sharded
    tree's bytes are one copy's."""
    from gofr_tpu_torch.tpu.generate import _tree_bytes

    cfg = pt_llama.config("tiny", dtype=torch.float32)
    params = pt_llama.init(cfg, 0, device="cpu")
    mesh = make_mesh({"dp": 2, "tp": 2}, CPU8[:4])
    sharded = pt_sharding.shard_pytree(params, mesh, pt_sharding.prune_specs(
        pt_sharding.llama_param_specs(), mesh))
    assert all(t is params["tok_emb"]
               for t in sharded["tok_emb"].shards.flat)
    wq = sharded["layers"]["wq"]
    assert wq.shard((0, 0)) is wq.shard((1, 0))
    assert wq.shard((0, 1)) is wq.shard((1, 1))
    assert len(wq.distinct_shards()) == 2
    assert wq.nbytes() == params["layers"]["wq"].nbytes
    assert _tree_bytes(sharded) == _tree_bytes(params)
    torch.testing.assert_close(pt_sharding.gather_pytree(sharded)["layers"],
                               params["layers"], rtol=0, atol=0)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_cache_shards_equal_jax(kv_int8):
    cfg = jax_llama.config("tiny", kv_int8=kv_int8)
    jcache = jax_llama.init_cache(cfg, 4, 16)
    rng = np.random.default_rng(0)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape) * 3).astype(
        v.dtype) for k, v in jcache.items()}
    jmesh = jax_mesh_mod.make_mesh({"dp": 4, "tp": 2})
    pmesh = make_mesh({"dp": 4, "tp": 2}, CPU8)
    jsharded = jax_sharding.shard_pytree(
        jcache, jmesh, jax_sharding.llama_cache_specs(kv_int8=kv_int8))
    pcache = from_jax_llama(jax.tree.map(np.asarray, jcache), "cpu")
    psharded = pt_sharding.shard_pytree(
        pcache, pmesh, pt_sharding.llama_cache_specs(kv_int8=kv_int8))
    _assert_same_shards(jsharded, psharded, jmesh)


# -- collectives ---------------------------------------------------------------
def test_collectives_on_one_device():
    devs = [torch.device("cpu")] * 3
    parts = [torch.full((2,), float(r), dtype=torch.bfloat16)
             for r in range(3)]
    summed = collectives.all_reduce(parts, devs)
    assert len(summed) == 3 and all(torch.equal(s, summed[0])
                                    for s in summed)
    assert summed[0].dtype == torch.bfloat16 and summed[0][0] == 3.0
    one = torch.randn(4)
    assert collectives.all_reduce([one], devs[:1])[0] is one
    gathered = collectives.all_gather(parts, devs, dim=0)
    assert gathered[1].tolist() == [0, 0, 1, 1, 2, 2]
    rotated = collectives.ppermute(parts, devs)
    assert [float(p[0]) for p in rotated] == [2.0, 0.0, 1.0]
    mesh = make_mesh({"dp": 2, "tp": 4}, CPU8)
    assert mesh.axis_coords("tp") == [[(d, r) for r in range(4)]
                                      for d in range(2)]
    assert mesh.axis_coords("sp") == [[c] for c in mesh.coords()]
    group = collectives.Group([mesh.devices[c]
                               for c in mesh.axis_coords("tp")[1]])
    assert group.size == 4
    assert group.all_reduce(parts[:1] * 4)[3][0] == 0.0


# -- ring attention, pipeline, forward(mesh=) --------------------------------
def _qkv(shape_q, shape_kv):
    rng = np.random.default_rng(1)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("axes,causal,batch_axis", [
    ({"sp": 4}, True, None), ({"dp": 2, "sp": 4}, False, "dp")])
def test_ring_attention_matches_jax(axes, causal, batch_axis):
    """tests/test_parallel.py:31-48 on both packages, f32, atol 1e-5."""
    shape_q, shape_kv = ((2, 32, 4, 16), (2, 32, 2, 16)) if causal \
        else ((4, 16, 2, 8), (4, 16, 2, 8))
    q, k, v = _qkv(shape_q, shape_kv)
    jmesh = jax_mesh_mod.make_mesh(axes)
    want = jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh,
                    causal=causal, batch_axis=batch_axis)
    got = ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), make_mesh(axes, CPU8),
                         causal=causal, batch_axis=batch_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    dense = (jax_prefill_attention if causal else jax_attention)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=1e-5)


@pytest.fixture(scope="module")
def tiny4():
    cfg = jax_llama.config("tiny", dtype=jnp.float32, n_layers=4)
    jparams = jax_llama.init(cfg, jax.random.PRNGKey(0))
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                           cfg.vocab_size))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, n_layers=4)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, tcfg, tparams, tokens


@pytest.mark.parametrize("axes,micro", [({"pp": 2}, 4), ({"pp": 4}, 2),
                                        ({"pp": 2, "dp": 2}, 2)])
def test_pp_forward_matches_jax(tiny4, axes, micro):
    cfg, jparams, tcfg, tparams, tokens = tiny4
    want = jax.jit(jax_pp_forward(cfg, jax_mesh_mod.make_mesh(axes),
                                  n_microbatches=micro))(jparams, tokens)
    got = make_pp_forward(tcfg, make_mesh(axes, CPU8), n_microbatches=micro)(
        tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    plain = pt_llama.forward(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)


def test_pp_forward_divisibility_errors_match_jax(tiny4):
    _, jparams, tcfg, tparams, _ = tiny4
    cfg3 = jax_llama.config("tiny", dtype=jnp.float32, n_layers=3)
    tcfg3 = dataclasses.replace(tcfg, n_layers=3)
    j3 = jax_llama.init(cfg3, jax.random.PRNGKey(0))
    p3 = from_jax_llama(jax.tree.map(np.asarray, j3), "cpu")
    jmesh = jax_mesh_mod.make_mesh({"pp": 2})
    pmesh = make_mesh({"pp": 2}, CPU8)
    for (jcfg, jp, pcfg, pp, batch) in ((cfg3, j3, tcfg3, p3, 4),
                                        (jax_llama.config(
                                            "tiny", dtype=jnp.float32,
                                            n_layers=4), jparams, tcfg,
                                         tparams, 3)):
        with pytest.raises(ValueError) as want:
            jax_pp_forward(jcfg, jmesh, n_microbatches=2)(
                jp, jnp.ones((batch, 8), jnp.int32))
        with pytest.raises(ValueError) as got:
            make_pp_forward(pcfg, pmesh, n_microbatches=2)(
                pp, torch.ones((batch, 8), dtype=torch.long))
        assert str(got.value) == str(want.value)


def test_forward_over_a_mesh_matches_jax(tiny4):
    """``llama.forward(mesh=)`` at dp 2 × tp 2 × sp 2, f32, atol 1e-5."""
    cfg, jparams, tcfg, tparams, tokens = tiny4
    axes = {"dp": 2, "tp": 2, "sp": 2}
    want = jax_llama.forward(jparams, cfg, jnp.asarray(tokens),
                             mesh=jax_mesh_mod.make_mesh(axes))
    got = pt_llama.forward(tparams, tcfg, torch.from_numpy(tokens),
                           mesh=make_mesh(axes, CPU8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tp_sharded_forward_matches_single_device(tiny4):
    """tests/test_parallel.py:51-64: the tp body (``TPShards``, one
    all-reduce after wo and after w_down, vocab-sharded logits) gives the
    unsharded forward's logits, and JAX's sharded forward's, at f32."""
    cfg, jparams, tcfg, tparams, tokens = tiny4
    pmesh = make_mesh({"dp": 2, "tp": 2}, CPU8)
    sharded = pt_sharding.shard_pytree(
        tparams, pmesh, pt_sharding.llama_param_specs())
    line = pmesh.axis_coords("tp")[0]
    ranks = pt_llama.TPShards(
        [pt_sharding.local_tree(sharded, c) for c in line],
        collectives.Group([pmesh.devices[c] for c in line]))
    assert ranks[1]["layers"]["wq"].shape == (4, 64, 32)
    got = pt_llama.forward(ranks, tcfg, torch.from_numpy(tokens))
    plain = pt_llama.forward(tparams, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    jmesh = jax_mesh_mod.make_mesh({"dp": 2, "tp": 2})
    jsharded = jax_sharding.shard_pytree(jparams, jmesh,
                                         jax_sharding.llama_param_specs())
    want = jax.jit(lambda p, t: jax_llama.forward(p, cfg, t))(
        jsharded, jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- multihost / dcn_check -----------------------------------------------------
def test_initialize_distributed_without_coordinator(monkeypatch):
    from gofr_tpu.parallel import multihost as jax_multihost

    monkeypatch.delenv("JAX_COORDINATOR", raising=False)
    assert multihost.initialize_distributed() is False
    assert jax_multihost.initialize_distributed() is False
    info = multihost.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    mesh = multihost.hybrid_mesh({"dp": 2, "tp": 2}, {"dp_outer": 1},
                                 devices=CPU8[:4])
    assert dict(mesh.shape) == {"dp_outer": 1, "dp": 2, "tp": 2}
    assert mesh.process_count == 1
    with pytest.raises(ValueError) as want:
        jax_multihost.hybrid_mesh({"dp": 8}, {"dp_outer": 2})
    with pytest.raises(ValueError) as got:
        multihost.hybrid_mesh({"dp": 8}, {"dp_outer": 2}, devices=CPU8)
    assert str(got.value) == str(want.value)


def test_two_process_dcn_check_reports_the_global_sum():
    """tests/test_dcn_two_process.py on the port: two processes over gloo,
    4 CPU shards each, one all-reduce across the process boundary."""
    from gofr_tpu_torch.parallel.dcn_check import run_two_process_check

    reports = run_two_process_check(local_devices=4, timeout=120,
                                    device="cpu")
    assert sorted(r["process"] for r in reports) == [0, 1]
    for report in reports:
        assert report["ok"] and report["psum"] == 28.0
        assert report["global_devices"] == 8
        assert report["backend"] == "gloo"
