"""Port parity for the device-resident sampler keys (``ops/prng``) and the
key-based sampler (``ops/sampling``) against ``jax.random`` and the JAX
package's sampler, on numpy-made keys and logits.

- ``seed_key``, ``split``, ``random_bits`` and ``uniform`` are
  bit-identical to ``jax.random.PRNGKey``/``split``/``bits``/``uniform``
  (jax 0.9: ``jax_threefry_partitionable`` on).
- ``sample_batch`` and ``speculative_accept`` give the JAX functions'
  carry keys bit for bit, and their tokens (and accept counts) wherever
  the row's two best Gumbel scores are more than 1e-5 apart: a Gumbel
  score goes through two logarithms whose last bit may differ between
  torch and XLA. Over the 2000 mixed rows here every row agrees (rate
  1.0); the test holds the rate to at least 0.999 and every row without
  such a near-tie to exact agreement.
- The sampled first token's distribution over 20k keys is within total
  variation 0.03 of the filtered distribution (noise about 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops import sampling as jax_sampling
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops import sampling as pt_sampling


def _keys(rng, shape):
    """Arbitrary uint32 key words (not only seed-made keys)."""
    return rng.integers(0, 2 ** 32, (*shape, 2), dtype=np.uint64).astype(
        np.uint32)


def _pt(keys):
    return torch.from_numpy(keys.astype(np.int64))


def test_seed_key_is_prngkey():
    seeds = np.array([0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1], np.uint32)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    got = prng.seed_key(torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_split_bit_identical(n):
    keys = _keys(np.random.default_rng(n), (5,))
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.split(_pt(keys), n).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (1000,)])
def test_bits_and_uniform_bit_identical(shape):
    keys = _keys(np.random.default_rng(len(shape) * 10 + shape[0]), (4,))
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.random_bits(_pt(keys), shape).numpy(),
                                  bits.astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.5, 3.0)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=lo, maxval=hi))(jnp.asarray(keys)))
        got = prng.uniform(_pt(keys), shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _near_tie(keys, scores):
    """Rows whose two best Gumbel-perturbed scores lie within 1e-5."""
    noisy = (prng.gumbel(keys, (scores.shape[-1],)) + scores).flatten(
        0, -2)
    top2 = noisy.topk(2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]) <= 1e-5).reshape(scores.shape[:-1])


def _batch(seed, rows=2000, vocab=512):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    temps = rng.choice([0.0, 0.5, 1.0, 1.5], rows).astype(np.float32)
    top_k = rng.choice([0, 5, 50], rows).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], rows).astype(np.float32)
    return rng, logits, temps, top_k, top_p, _keys(rng, (rows,))


def test_sample_batch_matches_jax():
    rng, logits, temps, top_k, top_p, keys = _batch(1)
    want, want_keys = jax_sampling.sample_batch(
        *(jnp.asarray(a) for a in (logits, temps, top_k, top_p, keys)))
    tt = torch.from_numpy
    got, got_keys = pt_sampling.sample_batch(
        tt(logits), tt(temps), tt(top_k).long(), tt(top_p), _pt(keys))
    np.testing.assert_array_equal(got_keys.numpy(),
                                  np.asarray(want_keys).astype(np.int64))
    agree = got.numpy() == np.asarray(want)
    # the draw's scores: the sorted, masked, scaled logits
    _, masked = pt_sampling._sorted_masked(tt(logits), tt(temps),
                                           tt(top_k).long(), tt(top_p))
    tie = _near_tie(prng.split(_pt(keys), 2)[:, 0], masked).numpy()
    sampled = temps > 0
    assert agree[~(tie & sampled)].all()
    assert agree.mean() >= 0.999
    assert (got.numpy()[~sampled] == logits[~sampled].argmax(-1)).all()


def test_speculative_accept_matches_jax():
    rng, _, temps, top_k, top_p, keys = _batch(2)
    rows, g, vocab = len(temps), 4, 512
    t_logits = (rng.standard_normal((rows, g + 1, vocab)) * 2).astype(
        np.float32)
    q = (rng.standard_normal((rows, g, vocab)) * 2).astype(np.float32)
    q_logp = q - np.log(np.exp(q).sum(-1, keepdims=True))
    drafts = rng.integers(0, vocab, (rows, g)).astype(np.int32)
    drafts[: rows // 2] = q_logp[: rows // 2].argmax(-1)   # likely accepts
    args = (t_logits, q_logp, drafts, temps, top_k, top_p)
    want = jax_sampling.speculative_accept(
        *(jnp.asarray(a) for a in args), jnp.asarray(keys))
    tt = torch.from_numpy
    got = pt_sampling.speculative_accept(
        tt(t_logits), tt(q_logp), tt(drafts), tt(temps), tt(top_k).long(),
        tt(top_p), _pt(keys))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2]).astype(np.int64))
    agree = (got[0].numpy() == np.asarray(want[0])).all(-1) \
        & (got[1].numpy() == np.asarray(want[1]))
    assert agree.mean() >= 0.999
    assert agree[temps <= 0].all()
    assert (got[1].numpy() > 0).any() and (got[1].numpy() < g).any()


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0),
                                                     (0.7, 8, 0.9)])
def test_sample_batch_follows_the_filtered_distribution(temperature, top_k,
                                                        top_p):
    rng = np.random.default_rng(5)
    vocab, n = 16, 20000
    row = rng.standard_normal(vocab).astype(np.float32)
    logits = torch.from_numpy(row).expand(n, vocab)
    tokens, _ = pt_sampling.sample_batch(
        logits, torch.full((n,), temperature),
        torch.full((n,), top_k, dtype=torch.long), torch.full((n,), top_p),
        prng.split(prng.seed_key(torch.tensor(9)), n))
    p = pt_sampling.filtered_log_probs(torch.from_numpy(row), temperature,
                                       top_k, top_p).exp().numpy()
    counts = np.bincount(tokens.numpy(), minlength=vocab)
    assert 0.5 * np.abs(counts / n - p).sum() < 0.03
