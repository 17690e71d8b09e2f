"""Port parity for the executor path's models on the CPU: ResNet
(``tiny``) and BERT (``tiny``) against ``gofr_tpu.models.resnet.apply``
and ``bert.apply`` on the same weights (converted from the JAX pytree)
and inputs (numpy, seeded).

- float32: ``atol`` and ``rtol`` 1e-4 on every output;
- bfloat16: ``max|port - jax| / max|jax|`` within 2e-2 (two bf16 roundings
  a layer apart in different orders), and BERT's ``mean`` with cosine at
  least 0.999 per row;
- a BERT batch with a padding row (an all-zero mask) and ragged masks:
  the padding row's outputs equal JAX's as well (both attend uniformly
  over its positions; its mean is 0);
- the converters: HWIO kernels come back as OIHW ``channels_last`` that
  turn back into JAX's arrays bit for bit; BERT's stacked tree as is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as jax_bert
from gofr_tpu.models import resnet as jax_resnet
from gofr_tpu_torch.models import bert, resnet
from gofr_tpu_torch.models.convert import from_jax_bert, from_jax_resnet

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _images(batch, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _tokens(batch, seq, seed=1, lengths=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, size=(batch, seq)).astype(np.int32)
    mask = np.zeros((batch, seq), np.int32)
    for row, n in enumerate(lengths or [seq] * batch):
        mask[row, :n] = 1
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_tiny_as_jax(dtype):
    jcfg = jax_resnet.config("tiny", dtype=getattr(jnp, dtype))
    jparams = jax.jit(jax_resnet.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    images = _images(3, jcfg.image_size)
    ref = np.asarray(jax.jit(jax_resnet.apply, static_argnums=1)(
        jparams, jcfg, jnp.asarray(images)))
    tcfg = resnet.config("tiny", dtype=getattr(torch, dtype))
    out = resnet.apply(from_jax_resnet(_np(jparams), "cpu"), tcfg,
                       torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    else:
        assert _rel(out.numpy(), ref) <= BF16_REL


def _bert_run(dtype, lengths):
    jcfg = jax_bert.config("tiny", dtype=getattr(jnp, dtype))
    jparams = jax_bert.init(jcfg, jax.random.PRNGKey(4))
    ids, mask = _tokens(len(lengths), jcfg.max_len, lengths=lengths)
    # op by op: at bf16 JAX's own jit of it differs from it by up to
    # 2.2e-2 of the pooled output's max (XLA fuses across the roundings)
    ref = jax_bert.apply(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    tcfg = bert.config("tiny", dtype=getattr(torch, dtype))
    out = bert.apply(from_jax_bert(_np(jparams), "cpu"), tcfg,
                     torch.from_numpy(ids), torch.from_numpy(mask))
    return ({k: np.asarray(v, np.float32) for k, v in ref.items()},
            {k: v.float().numpy() for k, v in out.items()})


# row 2 is a padding row (all-zero mask), the others ragged
LENGTHS = [64, 5, 0, 33]


def test_bert_tiny_f32_as_jax_with_a_padding_row():
    ref, out = _bert_run("float32", LENGTHS)
    for key in ("sequence", "pooled", "mean"):
        np.testing.assert_allclose(out[key], ref[key], **F32_TOL,
                                   err_msg=key)
    assert not out["mean"][2].any()


def test_bert_tiny_bf16_as_jax():
    ref, out = _bert_run("bfloat16", LENGTHS)
    for key in ("sequence", "pooled", "mean"):
        assert _rel(out[key], ref[key]) <= BF16_REL, key
    live = [0, 1, 3]
    a, b = out["mean"][live], ref["mean"][live]
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)
    assert cos.min() >= 0.999


def test_converters_round_trip():
    jparams = _np(jax.jit(jax_resnet.init, static_argnums=0)(
        jax_resnet.config("tiny"), jax.random.PRNGKey(0)))
    port = from_jax_resnet(jparams, "cpu")
    stem = port["stem"]["w"]
    assert stem.is_contiguous(memory_format=torch.channels_last)
    assert stem.dtype == torch.bfloat16 and stem.shape == (8, 3, 7, 7)
    back = stem.permute(2, 3, 1, 0).float().numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jparams["stem"]["w"], np.float32))
    blocks = port["stages"][1]
    assert isinstance(blocks, list) and "proj" in blocks[0]
    np.testing.assert_array_equal(
        port["head"]["w"].float().numpy(),
        np.asarray(jparams["head"]["w"], np.float32))
    bparams = _np(jax_bert.init(jax_bert.config("tiny"),
                                jax.random.PRNGKey(0)))
    bport = from_jax_bert(bparams, "cpu")
    assert bport["layers"]["wq"].shape == (2, 64, 64)
    np.testing.assert_array_equal(
        bport["layers"]["w_in"].float().numpy(),
        np.asarray(bparams["layers"]["w_in"], np.float32))
