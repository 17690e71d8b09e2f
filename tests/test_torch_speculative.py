"""Port parity for speculative draft-verify decode.

- ``speculative_accept``: greedy rows equal the JAX package's exactly,
  carry keys included; sampled rows draw with per-row threefry keys
  (``ops/prng``), and the first committed token's empirical distribution
  over 20k rows, each with its own key, is held within total variation
  0.03 of the target's filtered distribution (sampling noise at this
  size is about 0.01). Token parity of sampled rows with JAX is in
  tests/test_torch_prng.py.
- ``decode_step`` (dense cache, flash-decode wrapper) against the JAX
  ``decode_step`` with ``use_flash_decode=True`` on a 2-layer config
  whose shapes tile the Pallas flash-decode kernel (head_dim 128, Hq 8,
  T 256), so the JAX side runs its kernel in interpret mode; a row whose
  position is past the cache writes nothing.
- ``verify_step_paged`` logits and pool writes against the JAX
  ``verify_step_paged(ragged=True)`` (ragged verify kernel, interpret
  mode).
- Engine parity on ``tiny`` at float32, paged (``kv_page=4``), γ=4, the
  JAX engine with ``ragged_attn="on"``: with draft = target and with an
  independently initialised draft, the port's spec engine emits the
  greedy tokens of the JAX spec engine and of the port's plain engine,
  and every page returns to the pool.
- The adaptive-γ controller's window arithmetic.

Bounds: logits ``atol=1e-4`` and KV ``atol=1e-5`` (float32, as in
test_torch_llama); KV ``atol=1e-4`` on the 1024-wide config, whose K/V
rows are 1024-term dots summed in another order.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.ops.sampling import speculative_accept as jax_accept
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops.sampling import (filtered_log_probs,
                                         speculative_accept)
from gofr_tpu_torch.tpu import generate as pt_generate
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1]]
BUDGET = 12
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 paged_kv=True, kv_page=4)


# -- speculative_accept --------------------------------------------------------

def _jax_greedy(t_logits, q_logp, drafts):
    b = t_logits.shape[0]
    out, count, carry = jax_accept(
        jnp.asarray(t_logits), jnp.asarray(q_logp), jnp.asarray(drafts),
        jnp.zeros((b,), jnp.float32), jnp.zeros((b,), jnp.int32),
        jnp.ones((b,), jnp.float32),
        jax.random.split(jax.random.PRNGKey(0), b))
    return np.asarray(out), np.asarray(count), np.asarray(carry)


def _keys(seed, n):
    """``jax.random.split(jax.random.PRNGKey(seed), n)`` in the port."""
    return prng.split(prng.seed_key(torch.tensor(seed)), n)


def test_accept_greedy_equals_jax():
    rng = np.random.default_rng(0)
    b, g, vocab = 6, 4, 32
    t_logits = rng.standard_normal((b, g + 1, vocab)).astype(np.float32)
    argmax = t_logits.argmax(-1)
    drafts = argmax[:, :g].copy()
    # row r agrees with the target's argmax on its first r proposals
    for row in range(b):
        if row < g:
            drafts[row, row] = (drafts[row, row] + 1) % vocab
    q_logp = np.full((b, g, vocab), -np.log(vocab), np.float32)
    want_out, want_count, want_carry = _jax_greedy(t_logits, q_logp,
                                                   drafts.astype(np.int32))
    out, count, carry = speculative_accept(
        torch.from_numpy(t_logits), torch.from_numpy(q_logp),
        torch.from_numpy(drafts), torch.zeros(b),
        torch.zeros(b, dtype=torch.long), torch.ones(b), _keys(0, b))
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_array_equal(carry.numpy(), want_carry)
    assert count.tolist() == [0, 1, 2, 3, 4, 4]


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0),
                                                     (0.7, 8, 0.9)])
def test_accept_sampled_first_token_follows_target(temperature, top_k,
                                                   top_p):
    """An adversarial draft (its own distribution, unrelated to the
    target) still commits first tokens distributed as the target's
    filtered distribution."""
    rng = np.random.default_rng(42)
    vocab, g, n = 16, 2, 20000
    t_row = rng.standard_normal((g + 1, vocab)).astype(np.float32)
    q_logits = 3.0 * rng.standard_normal((g, vocab))
    q_row = (q_logits - np.log(np.exp(q_logits).sum(-1, keepdims=True))) \
        .astype(np.float32)
    drafts = np.stack([rng.choice(vocab, size=n, p=np.exp(q_row[i]))
                       for i in range(g)], axis=1)
    out, _, _ = speculative_accept(
        torch.from_numpy(t_row).expand(n, g + 1, vocab),
        torch.from_numpy(q_row).expand(n, g, vocab),
        torch.from_numpy(drafts), torch.full((n,), temperature),
        torch.full((n,), top_k, dtype=torch.long), torch.full((n,), top_p),
        _keys(3, n))
    p = filtered_log_probs(torch.from_numpy(t_row[0]), temperature, top_k,
                           top_p).exp().numpy()
    counts = np.bincount(out[:, 0].numpy(), minlength=vocab)
    tv = 0.5 * np.abs(counts / n - p).sum()
    assert tv < 0.03, f"TV distance {tv:.4f} vs target distribution"


# -- model steps ---------------------------------------------------------------

@pytest.fixture(scope="module")
def flash_models():
    """A 2-layer config that tiles the Pallas flash-decode kernel."""
    over = dict(vocab_size=256, dim=1024, n_layers=2, n_heads=8,
                n_kv_heads=2, ffn_dim=256, max_seq_len=256)
    jcfg = jax_llama.config("tiny", dtype=jnp.float32,
                            use_flash_decode=True, **over)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(1))
    tcfg = pt_llama.config("tiny", dtype=torch.float32,
                           use_flash_decode=True, **over)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_decode_step_dense_flash_matches_jax(flash_models):
    jcfg, jparams, tcfg, tparams = flash_models
    rng = np.random.default_rng(5)
    b, t = 4, 256
    shape = (tcfg.n_layers, b, t, tcfg.n_kv_heads, tcfg.head_dim)
    cache = {name: rng.standard_normal(shape).astype(np.float32)
             for name in ("k", "v")}
    lens = np.array([0, 5, 130, 254], np.int32)
    step = jax.jit(lambda p, tok, c, n: jax_llama.decode_step(p, jcfg, tok,
                                                              c, n))
    jcache = {name: jnp.asarray(a) for name, a in cache.items()}
    tcache = {name: torch.from_numpy(a.copy()) for name, a in cache.items()}
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    token = rng.integers(0, 256, b).astype(np.int32)
    for _ in range(2):
        jlogits, jcache, jlen = step(jparams, jnp.asarray(token), jcache,
                                     jlen)
        tlogits, tcache, tlen = pt_llama.decode_step(
            tparams, tcfg, torch.from_numpy(token).long(), tcache, tlen)
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                                   atol=1e-4)
        token = np.asarray(jlogits).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    for name in ("k", "v"):       # K/V rows are 1024-term dots here
        np.testing.assert_allclose(np.asarray(jcache[name]),
                                   tcache[name].numpy(), atol=1e-4)


def test_decode_step_dense_drops_positions_past_the_cache():
    """A row at the cache's end writes nothing; the others write their
    own position only."""
    cfg = pt_llama.config("tiny", dtype=torch.float32)
    params = pt_llama.init(cfg, 3, device="cpu")
    cache = pt_llama.init_cache(cfg, 3, 4, device="cpu")
    lens = torch.tensor([4, 2, 0], dtype=torch.int32)
    _, cache, new_len = pt_llama.decode_step(
        params, cfg, torch.tensor([1, 2, 3]), cache, lens)
    assert new_len.tolist() == [5, 3, 1]
    for name in ("k", "v"):
        written = cache[name].abs().sum(dim=(0, -1, -2)) > 0    # (B, T)
        assert written.tolist() == [[False] * 4,
                                    [False, False, True, False],
                                    [True, False, False, False]]


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_verify_step_paged_matches_jax_ragged(tiny_models):
    """Three rows, G = 3, the last row inactive (it must not write)."""
    jcfg, jparams, tcfg, tparams = tiny_models
    rng = np.random.default_rng(6)
    page, num_pages, width, g_len = 4, 16, 4, 3
    shape = (tcfg.n_layers, num_pages, page, tcfg.n_kv_heads,
             tcfg.head_dim)
    pool = {name: rng.standard_normal(shape).astype(np.float32)
            for name in ("k", "v")}
    lens = np.array([5, 8, 2], np.int32)
    table = np.full((3, width), num_pages, np.int32)
    nxt = 0
    for row, n in enumerate(lens):
        for col in range(-(-(int(n) + g_len) // page)):
            table[row, col] = nxt
            nxt += 1
    active = np.array([True, True, False])
    tokens = rng.integers(0, 256, (3, g_len)).astype(np.int32)
    jlogits, jpool = jax.jit(
        lambda p, tok, pl, tb, cl, act: jax_llama.verify_step_paged(
            p, jcfg, tok, pl, tb, cl, act, ragged=True))(
        jparams, jnp.asarray(tokens),
        {name: jnp.asarray(a) for name, a in pool.items()},
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(active))
    tpool = {name: torch.from_numpy(np.concatenate(
        [a, np.zeros_like(a[:, :1])], axis=1))      # + the scratch row
        for name, a in pool.items()}
    tlogits, tpool = pt_llama.verify_step_paged(
        tparams, tcfg, torch.from_numpy(tokens).long(), tpool,
        torch.from_numpy(table), torch.from_numpy(lens),
        torch.from_numpy(active))
    assert tlogits.shape == (3, g_len, tcfg.vocab_size)
    np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jpool[name]),
                                   tpool[name][:, :num_pages].numpy(),
                                   atol=1e-5)
        # the inactive row's pages keep what they held
        np.testing.assert_array_equal(tpool[name][:, table[2, 0]].numpy(),
                                      pool[name][:, table[2, 0]])


def test_verify_step_paged_drops_positions_past_the_table(tiny_models):
    """A row whose new tokens run past its table's reach writes only the
    positions the table covers, and never clamps onto a live page: the
    rest land in the scratch page at the sentinel id."""
    _, _, tcfg, tparams = tiny_models
    page, num_pages, width = 4, 4, 2
    shape = (tcfg.n_layers, num_pages + 1, page, tcfg.n_kv_heads,
             tcfg.head_dim)
    pool = {name: torch.zeros(shape) for name in ("k", "v")}
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([6], dtype=torch.int32)     # positions 6..9
    pt_llama.verify_step_paged(tparams, tcfg, torch.tensor([[1, 2, 3, 4]]),
                               pool, table, lens, torch.tensor([True]))
    written = pool["k"][0].abs().sum(dim=(-1, -2)) > 0   # (pages, page)
    assert written[1, 2:].all() and written[:num_pages].sum() == 2
    assert not written[0].any() and not written[2:num_pages].any()
    assert written[num_pages].any()                      # the scratch page


# -- engine --------------------------------------------------------------------

async def _serve(engine, prompts, sampling=None):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, max_new_tokens=BUDGET, sampling=sampling)
              for p in prompts]), 120.0))
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def engines():
    """The JAX spec engine's greedy output for each draft, computed once."""
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    jdraft = jax_llama.init(jcfg, jax.random.PRNGKey(7))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    tdraft = from_jax_llama(jax.tree.map(np.asarray, jdraft), "cpu")
    drafts = {"self": (jparams, tparams), "other": (jdraft, tdraft)}
    reference = {}
    for name, (jd, _) in drafts.items():
        container = new_mock_container()
        engine = JaxEngine(jcfg, jparams, logger=container.logger,
                           metrics=container.metrics,
                           ragged_attn="on", draft_cfg=jcfg,
                           draft_params=jd, spec_gamma=4, **ENGINE_KW)
        reference[name] = asyncio.run(_serve(engine, PROMPTS))
        assert engine.stats()["speculative"]["spec_ticks"] > 0
    return tcfg, tparams, drafts, reference


@pytest.fixture(scope="module")
def jax_spec_at_depth(engines):
    """The JAX spec engine's greedy output (the independent draft) at a
    pipeline depth and steps per tick, each computed once."""
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams, jdraft = engines[2]["self"][0], engines[2]["other"][0]
    cache = {}

    def run(inflight, steps_per_tick):
        if (inflight, steps_per_tick) not in cache:
            container = new_mock_container()
            engine = JaxEngine(jcfg, jparams, logger=container.logger,
                               metrics=container.metrics,
                               ragged_attn="on", draft_cfg=jcfg,
                               draft_params=jdraft, spec_gamma=4,
                               max_inflight_ticks=inflight,
                               steps_per_tick=steps_per_tick, **ENGINE_KW)
            cache[inflight, steps_per_tick] = asyncio.run(
                _serve(engine, PROMPTS))
        return cache[inflight, steps_per_tick]
    return run


def _spec_engine(engines, draft, **kw):
    tcfg, tparams, drafts, _ = engines
    dcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return GenerationEngine(tcfg, tparams, device="cpu", draft_cfg=dcfg,
                            draft_params=drafts[draft][1], spec_gamma=4,
                            **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("draft", ["self", "other"])
def test_spec_engine_greedy_identity(engines, draft):
    tcfg, tparams, _, reference = engines
    plain = asyncio.run(_serve(
        GenerationEngine(tcfg, tparams, device="cpu", **ENGINE_KW), PROMPTS))
    engine = _spec_engine(engines, draft)
    spec = asyncio.run(_serve(engine, PROMPTS))
    assert spec == reference[draft] == plain
    stats = engine.stats()
    st = stats["speculative"]
    assert st["spec_ticks"] > 0 and st["gamma_ladder"] == [1, 2, 4]
    assert st["proposed"] >= st["accepted"] >= 0
    assert engine.draft_steps >= 2 * engine.spec_dispatches
    if draft == "self":
        assert st["accepted"] == st["proposed"]
    assert stats["kv_pool"]["used_pages"] == 0     # every page came back
    assert stats["active_slots"] == 0


@pytest.mark.parametrize("steps_per_tick", [1, 4])
@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_spec_engine_greedy_identity_at_depth(engines, jax_spec_at_depth,
                                              inflight, steps_per_tick):
    engine = _spec_engine(engines, "other", max_inflight_ticks=inflight,
                          steps_per_tick=steps_per_tick)
    out = asyncio.run(_serve(engine, PROMPTS))
    assert out == jax_spec_at_depth(inflight, steps_per_tick) \
        == engines[3]["other"]
    stats = engine.stats()
    assert stats["speculative"]["spec_ticks"] > 0
    assert min(inflight, 2) <= stats["ticks_inflight_peak"] <= inflight
    assert stats["kv_pool"]["used_pages"] == 0 and stats["active_slots"] == 0


def test_spec_engine_sampled_requests_complete(engines):
    engine = _spec_engine(engines, "other")
    sampling = Sampling(temperature=0.9, top_k=12, seed=5)
    outs = asyncio.run(_serve(engine, [[4, 5, 6]] * 3, sampling=sampling))
    assert [len(out) for out in outs] == [BUDGET] * 3
    assert all(0 <= t < 256 for out in outs for t in out)
    assert engine.stats()["kv_pool"]["used_pages"] == 0


def test_spec_engine_rejects_a_draft_of_another_vocabulary(engines):
    tcfg, tparams, drafts, _ = engines
    dcfg = pt_llama.config("tiny", dtype=torch.float32, vocab_size=128)
    with pytest.raises(ValueError, match="vocabulary"):
        GenerationEngine(tcfg, tparams, device="cpu", draft_cfg=dcfg,
                         draft_params=drafts["other"][1], **ENGINE_KW)


def test_adaptive_gamma_shrinks_and_grows(engines):
    engine = _spec_engine(engines, "other")
    window = pt_generate._SPEC_WINDOW_TICKS
    assert window == 16 and engine._gamma_cap == 4

    def tick(proposed, accepted):
        """What _dispatch_spec does after a tick at rung 4."""
        engine.spec_rungs[4] = engine.spec_rungs.get(4, 0) + 1
        engine._note_spec(proposed, accepted)

    for _ in range(window):        # acceptance 1/4 < 0.5
        tick(4, 1)
    assert engine._gamma_cap == 2
    for _ in range(window - 1):    # the cap moves only at a window's end
        tick(4, 1)
    assert engine._gamma_cap == 2
    tick(4, 1)
    assert engine._gamma_cap == 1
    for _ in range(window):        # the floor holds
        tick(4, 0)
    assert engine._gamma_cap == 1
    for _ in range(window):        # acceptance 0.75: between thresholds
        tick(4, 3)
    assert engine._gamma_cap == 1
    for _ in range(2 * window):    # acceptance 1.0 > 0.8
        tick(4, 4)
    assert engine._gamma_cap == 4
    for _ in range(window):        # the ceiling holds
        tick(4, 4)
    assert engine._gamma_cap == 4
    tick(0, 0)                     # every slot cancelled: no proposal
    st = engine.stats()["speculative"]
    assert st["spec_ticks"] == 7 * window + 1
    assert st["proposed"] == 4 * 7 * window and engine._gamma_cap == 4
