"""Port parity for grammar-constrained decoding (``tpu/constrain.py`` and
the engine's biased prefill and ticks) against the JAX package on the CPU.

- ``CompiledGrammar``: for every DFA state reachable from the start of
  each pattern and schema of the JAX package's own constrain tests, the
  port's bias row is bit-equal to ``gofr_tpu.tpu.constrain``'s, and so
  are the allowed mask, the open count and acceptance, over the raw-byte
  vocabulary (256), a padded one (320 ids, eos an empty id inside it)
  and a merged one; states are discovered in the same order. The regex
  and schema front ends (``schema_to_regex``, ``canonical_source``,
  ``token_byte_table``, ``GrammarError``) agree too.
- The engine at ``tiny``, float32: one burst of a regex, a JSON schema,
  an object schema (integer and string properties) and an unconstrained
  request gives the JAX engine's greedy tokens, on the dense and paged
  layouts, plain, speculative and ``kv_int8``; every constrained output
  walks its grammar, and the unconstrained one equals its solo run
  (bf16 cache).
- A seeded sampled constrained request gives the JAX engine's tokens,
  except at a step where the row's two best Gumbel scores lie within
  1e-5 (``tests/test_torch_prng.py``'s allowance).
- A bad ``response_format`` raises ``GrammarError`` at the call, with
  nothing queued; the grammar-cache stats equal JAX's; with the prefix
  store on, a constrained request prefills at rung 0.

The JAX engines run once per module.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import constrain as jax_constrain
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops import sampling as pt_sampling
from gofr_tpu_torch.tpu import constrain as pt_constrain
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling

# -- compiled grammars ---------------------------------------------------------

REGEXES = ["abc", "(ab|cd)+", "a{2,4}", r"[a-c]\d+\.x?", "[^0-9]+",
           r"-?\d+(\.\d+)?", "héllo", r"a.c", "(yes|no)!", "(ab)+", "ab",
           "abc+"]
OBJECT_SCHEMA = {"type": "object",
                 "properties": {"name": {"type": "string"},
                                "age": {"type": "integer"},
                                "ok": {"type": "boolean"}},
                 "required": ["name", "age", "ok"]}
SCHEMAS = [OBJECT_SCHEMA, {"enum": ["a", "b"]}, {"const": 42},
           {"type": "array", "items": {"type": "integer"}, "minItems": 1,
            "maxItems": 2},
           {"anyOf": [{"type": "integer"}, {"type": "null"}]},
           {"type": "object", "properties": {"ok": {"type": "boolean"}}},
           {"type": "number"}]


class _MergedTok:
    merges = [(ord("a"), ord("b")), (256, ord("c")), (ord("y"), ord("e")),
              (258, ord("s"))]


def _tables(impl):
    """(name, token table, eos id) of each vocabulary."""
    return {"bytes256": (impl.token_byte_table(vocab_size=256), None),
            "padded320": (impl.token_byte_table(vocab_size=320), 300),
            "merged": (impl.token_byte_table(_MergedTok()), None)}


def _states(grammar):
    """Every state reachable from the start, in discovery order."""
    order, seen, at = [grammar.start], {grammar.start}, 0
    while at < len(order):
        state = order[at]
        at += 1
        for token in range(grammar.vocab):
            dest = grammar.token_dest(state, token)
            if dest >= 0 and dest not in seen:
                seen.add(dest)
                order.append(dest)
    return order


@pytest.mark.parametrize("table", ["bytes256", "padded320", "merged"])
@pytest.mark.parametrize("source", REGEXES + [json.dumps(s) for s in SCHEMAS])
def test_bias_rows_bit_equal_to_jax_at_every_state(source, table):
    if source.startswith("{"):
        pattern = jax_constrain.schema_to_regex(json.loads(source))
        assert pt_constrain.schema_to_regex(json.loads(source)) == pattern
    else:
        pattern = source
    j_table, eos = _tables(jax_constrain)[table]
    p_table, _ = _tables(pt_constrain)[table]
    assert p_table == j_table
    want = jax_constrain.CompiledGrammar(pattern, j_table, eos)
    got = pt_constrain.CompiledGrammar(pattern, p_table, eos)
    states = _states(got)
    assert states == _states(want) and len(states) > 1
    for state in states:
        row, ref = got.bias_row(state), want.bias_row(state)
        assert row.dtype == np.float32 and row.shape == (len(p_table),)
        np.testing.assert_array_equal(row.view(np.int32), ref.view(np.int32))
        np.testing.assert_array_equal(got.allowed_mask(state),
                                      want.allowed_mask(state))
        assert got.open_count(state) == want.open_count(state)
        assert got.accepting(state) == want.accepting(state)
    assert got.stats()["dfa_states"] == want.stats()["dfa_states"]
    assert pt_constrain.NEG_BIAS == jax_constrain.NEG_BIAS
    assert pt_constrain.NEG_BIAS.dtype == np.float32


@pytest.mark.parametrize("bad", ["(", "a**{", "[z-a]", "(?=x)", "a{4,2}",
                                 r"\k<name>", "x" * 4097])
def test_malformed_patterns_raise_as_in_jax(bad):
    table = pt_constrain.token_byte_table(vocab_size=256)
    with pytest.raises(jax_constrain.GrammarError):
        jax_constrain.CompiledGrammar(bad, table, None)
    with pytest.raises(pt_constrain.GrammarError):
        pt_constrain.CompiledGrammar(bad, table, None)
    assert issubclass(pt_constrain.GrammarError, ValueError)


@pytest.mark.parametrize("response_format", [
    {"type": "regex", "pattern": "a+"},
    {"type": "json_schema", "schema": {"type": "integer"}},
    {"type": "json_schema", "json_schema": {"name": "x",
                                            "schema": {"type": "null"}}},
    {"type": "json_schema", "json_schema": {"type": "boolean"}}])
def test_canonical_source_as_in_jax(response_format):
    assert pt_constrain.canonical_source(response_format) == \
        jax_constrain.canonical_source(response_format)


def test_walker_and_grammar_cache_as_in_jax():
    for impl in (jax_constrain, pt_constrain):
        table = impl.token_byte_table(vocab_size=256)
        cache = impl.GrammarCache(table, max_entries=2)
        first = cache.get({"type": "regex", "pattern": "(yes|no)!"}, None)
        assert cache.get({"type": "regex", "pattern": "(yes|no)!"},
                         None) is first
        cache.get({"type": "json_schema", "schema": {"type": "integer"}}, 7)
        cache.get({"type": "regex", "pattern": "b+"}, None)   # evicts first
        assert cache.stats() == {"entries": 2, "hits": 1, "misses": 3}
        walker = impl.GrammarWalker(first)
        for byte in b"no":
            assert walker.advance(byte) and not walker.must_stop
        assert walker.advance(ord("!")) and walker.must_stop
        assert walker.accepting and not walker.violated
        walker = impl.GrammarWalker(first)
        assert not walker.advance(ord("x")) and walker.must_stop


# -- the engine ----------------------------------------------------------------

REGEX_RF = {"type": "regex", "pattern": "(yes|no)!"}
BOOL_RF = {"type": "json_schema",
           "json_schema": {"type": "object",
                           "properties": {"ok": {"type": "boolean"}},
                           "required": ["ok"]}}
OBJECT_RF = {"type": "json_schema",
             "schema": {"type": "object",
                        "properties": {"n": {"type": "integer"},
                                       "s": {"type": "string"}}}}
# (prompt, budget, response_format); the last is unconstrained
BURST = [([1, 2, 3], 8, REGEX_RF),
         ([4, 5, 6, 7, 8], 16, BOOL_RF),
         (list(range(1, 11)), 24, OBJECT_RF),
         ([5, 6, 7], 12, None)]
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
LAYOUTS = {"dense": {}, "paged": dict(paged_kv=True, kv_page=8)}
VARIANTS = ("plain", "spec", "int8")
SAMPLED = [([1, 2, 3], 8, REGEX_RF, (0.8, 0, 1.0, 3)),
           ([2, 4, 6, 8], 24, OBJECT_RF, (1.0, 0, 0.9, 11))]


async def _serve(engine, requests, sampling=None):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, max_new_tokens=n, response_format=rf,
                            sampling=sampling(*s[0]) if sampling else None)
            for p, n, rf, *s in requests]), 120.0))
    finally:
        await engine.stop()


def _cfgs(**over):
    return (jax_llama.config("tiny", dtype=jnp.float32, use_flash=True,
                             **over),
            pt_llama.config("tiny", dtype=torch.float32, use_flash=True,
                            **over))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's outputs for the burst on each (layout, spec), the
    solo unconstrained request and the sampled requests (dense plain),
    with the grammar-cache stats of each engine; computed once."""
    jcfg, _ = _cfgs()
    weights = jax.tree.map(np.asarray,
                           jax_llama.init(jcfg, jax.random.PRNGKey(0)))
    jdcfg = dataclasses.replace(jcfg, n_layers=1)
    draft = jax.tree.map(np.asarray,
                         jax_llama.init(jdcfg, jax.random.PRNGKey(7)))
    out = {"weights": weights, "draft": draft}

    def engine(layout, variant="plain"):
        container = new_mock_container()
        kw = dict(draft_cfg=jdcfg, draft_params=draft,
                  spec_gamma=2) if variant == "spec" else {}
        return JaxEngine(dataclasses.replace(jcfg,
                                             kv_int8=variant == "int8"),
                         weights, logger=container.logger,
                         metrics=container.metrics, **ENGINE_KW,
                         **LAYOUTS[layout], **kw)
    for layout in LAYOUTS:
        for variant in VARIANTS:
            e = engine(layout, variant)
            out[layout, variant] = asyncio.run(_serve(e, BURST))
            out[layout, variant, "stats"] = e.stats()["constrained"]
    out["solo"] = asyncio.run(_serve(engine("dense"), BURST[-1:]))

    def jax_sampling(temperature, top_k, top_p, seed):
        from gofr_tpu.tpu.generate import Sampling as JaxSampling
        return JaxSampling(temperature, top_k, top_p, seed)
    out["sampled"] = asyncio.run(_serve(engine("dense"), SAMPLED,
                                        jax_sampling))
    return out


def _port_engine(jax_runs, layout="dense", variant="plain", **kw):
    _, tcfg = _cfgs()
    if variant == "int8":
        tcfg = dataclasses.replace(tcfg, kv_int8=True)
    if variant == "spec":
        kw.update(draft_cfg=dataclasses.replace(tcfg, n_layers=1),
                  draft_params=from_jax_llama(jax_runs["draft"], "cpu"),
                  spec_gamma=2)
    return GenerationEngine(tcfg, from_jax_llama(jax_runs["weights"], "cpu"),
                            device="cpu", **ENGINE_KW, **LAYOUTS[layout],
                            **kw)


def _walks(rf, tokens):
    """The tokens walk the grammar without a violation; a walker that
    reached ``must_stop`` has a full match."""
    table = pt_constrain.token_byte_table(vocab_size=256)
    grammar = pt_constrain.GrammarCache(table).get(rf, None)
    walker = pt_constrain.GrammarWalker(grammar)
    for token in tokens:
        assert not walker.must_stop, tokens
        assert walker.advance(token), tokens
    assert not walker.must_stop or grammar.fullmatch(tokens)
    return walker.must_stop


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_constrained_greedy_tokens_equal_jax(jax_runs, layout, variant):
    engine = _port_engine(jax_runs, layout, variant)
    outs = asyncio.run(_serve(engine, BURST))
    assert outs == jax_runs[layout, variant]
    for (_, budget, rf), tokens in zip(BURST, outs):
        if rf is not None:
            assert _walks(rf, tokens) or len(tokens) == budget
    assert bytes(outs[0]).decode() in ("yes!", "no!")
    assert set(json.loads(bytes(outs[1]).decode())) == {"ok"}
    # the unconstrained neighbour decoded as it does alone
    if variant != "int8":
        assert outs[-1] == jax_runs["solo"][0]
    stats = engine.stats()
    assert stats["constrained"]["ticks"] > 0
    if layout == "paged":
        assert stats["kv_pool"]["used_pages"] == 0


def test_unconstrained_tokens_equal_solo_run(jax_runs):
    solo = asyncio.run(_serve(_port_engine(jax_runs), BURST[-1:]))
    assert solo == jax_runs["solo"]
    mixed = asyncio.run(_serve(_port_engine(jax_runs), BURST))
    assert mixed[-1] == solo[0]


def test_grammar_cache_stats_equal_jax(jax_runs):
    for layout in LAYOUTS:
        engine = _port_engine(jax_runs, layout)
        asyncio.run(_serve(engine, BURST))
        got, want = engine.stats()["constrained"], \
            jax_runs[layout, "plain", "stats"]
        assert got["requests"] == want["requests"] == 3
        assert got["grammar_cache"] == want["grammar_cache"]
        assert got["ticks"] > 0 and want["ticks"] > 0


def _step_keys(seed, steps):
    """A slot's sampling key before each of its draws: the prefill's and
    each tick's draw split it once (``sample_batch``)."""
    keys, key = [], prng.seed_key(torch.tensor([seed]))
    for _ in range(steps):
        keys.append(key)
        key = prng.split(key, 2)[:, 1]
    return keys


def test_sampled_constrained_tokens_equal_jax_up_to_gumbel_ties(jax_runs):
    engine = _port_engine(jax_runs)
    outs = asyncio.run(_serve(engine, SAMPLED, Sampling))
    _, tcfg = _cfgs()
    params = from_jax_llama(jax_runs["weights"], "cpu")
    for (prompt, _, rf, (temp, top_k, top_p, seed)), got, want in zip(
            SAMPLED, outs, jax_runs["sampled"]):
        assert len(got) > 1
        _walks(rf, got)
        if got == want:
            continue
        # the first difference must sit on a near-tie of Gumbel scores
        at = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = prompt + got[:at]
        cache = pt_llama.init_cache(tcfg, 1, 64, device="cpu")
        logits, _, _ = pt_llama.prefill(
            params, tcfg, torch.tensor([seq + [0] * (64 - len(seq))]),
            cache, lengths=torch.tensor([len(seq)]))
        table = pt_constrain.token_byte_table(vocab_size=256)
        walker = pt_constrain.GrammarWalker(
            pt_constrain.GrammarCache(table).get(rf, None))
        for token in got[:at]:
            walker.advance(token)
        logits = logits + torch.from_numpy(walker.bias_row())
        _, masked = pt_sampling._sorted_masked(
            logits, torch.tensor([temp]), torch.tensor([top_k]),
            torch.tensor([top_p]))
        key = prng.split(_step_keys(seed, at + 1)[at], 2)[:, 0]
        noisy = prng.gumbel(key, (masked.shape[-1],)) + masked
        top2 = noisy.topk(2, dim=-1).values[0]
        assert float(top2[0] - top2[1]) <= 1e-5, (at, got, want)


def test_bad_response_format_raises_before_admission(jax_runs):
    engine = _port_engine(jax_runs)

    async def main():
        await engine.start()
        try:
            for bad in ({"type": "regex", "pattern": "("}, {"type": "nope"},
                        {"type": "json_schema", "schema": {"type": "set"}},
                        "not an object"):
                with pytest.raises(pt_constrain.GrammarError):
                    await engine.generate([1, 2, 3], 4, response_format=bad)
                with pytest.raises(ValueError):
                    await engine.generate_stream([1, 2, 3], 4,
                                                 response_format=bad)
                assert engine._pending.empty()
            # the engine still serves after the rejects
            return await engine.generate([1, 2, 3], 3)
        finally:
            await engine.stop()

    assert len(asyncio.run(main())) == 3
    assert engine.stats()["prefill_dispatches"] == 1
    assert "constrained" not in engine.stats()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_constrained_request_prefills_at_rung_zero_with_prefix_store(
        jax_runs, layout):
    """A head cached by an earlier request is hit by an unconstrained
    request and passed over by a constrained one with the same prompt,
    which prefills whole."""
    engine = _port_engine(jax_runs, layout, prefix_cache=True, prefix_page=4)
    prompt = list(range(20, 32))

    async def main():
        await engine.start()
        try:
            await engine.generate(prompt, 4)
            hit = await engine.generate(prompt, 4)
            suffix = engine.suffix_prefill_dispatches
            constrained = await engine.generate(prompt, 8,
                                                response_format=REGEX_RF)
            return hit, suffix, constrained
        finally:
            await engine.stop()

    hit, suffix, constrained = asyncio.run(main())
    assert suffix == 1 and engine.suffix_prefill_dispatches == 1
    assert engine.prefix_admissions[0] == 2
    assert sum(n for rung, n in engine.prefix_admissions.items() if rung) \
        == 1
    assert bytes(constrained).decode() in ("yes!", "no!")
    plain = asyncio.run(_serve(_port_engine(jax_runs, layout),
                               [(prompt, 8, REGEX_RF)]))
    assert plain == [constrained]
