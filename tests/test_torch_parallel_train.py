"""Port parity for training over a mesh (``parallel/train`` over
``Sharded`` state, ``llama.loss_fn(mesh=)``, the ep-sharded MoE,
checkpoints restored onto a mesh) against the JAX package on its virtual
8-CPU mesh (``tests/conftest.py``). The port's meshes list that many
``torch.device("cpu")`` entries, so every coordinate shares the CPU:
shards of one slice share one tensor, as on one card. ``tiny`` at
float32, inputs from a numpy seed, JAX's weights carried across by
``models/convert``'s ``mesh=`` forms.

Tolerances are ``tests/test_torch_train.py``'s: losses within 1e-6
relative; gradients 1e-6 absolute plus 1e-4 relative; moments 1e-4
relative plus 1e-7 (mu) or 1e-9 (nu) absolute; params within 1e-5 where
the first moment is settled (``settled``), 2·lr a step elsewhere. The
mesh's sum orders (the tp ranks' float32 partial products, the sp ring's
online softmax, dp rows' gradients summed by autograd) stay inside them:
measured worst, loss 1.6e-7 relative, gradients 2.1e-7 absolute, mu
2.2e-8, nu 5.8e-11, settled params 1.2e-7. MoE logits are held to
``tests/test_torch_moe.py``'s bound for the unsharded MoE (2e-5 absolute
plus 1e-5 relative; measured 2.4e-6, where the unsharded port's is
1.9e-6).

The JAX references are computed once per module (each JAX mesh step at
``tiny`` compiles for seconds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.models import moe as jax_moe
from gofr_tpu.ops import prefill_attention, rms_norm, rope_table
from gofr_tpu.parallel import make_eval_step as jax_make_eval_step
from gofr_tpu.parallel import make_mesh as jax_make_mesh
from gofr_tpu.parallel import make_train_step as jax_make_train_step
from gofr_tpu.parallel import prune_specs as jax_prune_specs
from gofr_tpu.parallel import shard_pytree as jax_shard_pytree
from gofr_tpu.parallel.sharding import moe_param_specs as jax_moe_specs
from gofr_tpu.utils import restore_checkpoint as jax_restore
from gofr_tpu.utils import save_checkpoint as jax_save
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import (from_jax_llama, from_jax_moe,
                                           from_jax_train_state)
from gofr_tpu_torch.parallel import (P, make_eval_step, make_mesh,
                                     make_train_step, shard_train_state)
from gofr_tpu_torch.parallel import sharding
from gofr_tpu_torch.parallel import train as pt_train
from gofr_tpu_torch.parallel.sharding import NamedSharding, Sharded
from gofr_tpu_torch.utils import restore_checkpoint, save_checkpoint
from gofr_tpu_torch.utils import tree as tree_util

LR = 3e-4
STEPS = 3
LOSS_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-4, atol=1e-9)
PARAM_TIGHT = 1e-5
LOGITS_TOL = dict(atol=2e-5, rtol=1e-5)
SP_AXES = {"dp": 2, "tp": 2, "sp": 2}


def cpus(n=8):
    return [torch.device("cpu")] * n


def _configs(**overrides):
    return (jax_llama.config("tiny", dtype=jnp.float32, **overrides),
            pt_llama.config("tiny", dtype=torch.float32, **overrides))


def _batch(vocab, seed, shape=(4, 32)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, shape)
    return tokens, np.roll(tokens, -1, axis=1)


def _np(tree):
    """Full leaves as float32 numpy arrays, by key."""
    return {key: (leaf.gather().float().numpy() if isinstance(leaf, Sharded)
                  else leaf.detach().float().numpy()
                  if isinstance(leaf, torch.Tensor)
                  else np.asarray(leaf, np.float32))
            for key, leaf in tree_util.flatten(tree).items()}


def settled(mu):
    return np.abs(mu) > 1e-2 * np.abs(mu).max()


def _jax_steps(jcfg, axes, tokens, targets, steps, **kw):
    init_fn, step_fn = jax_make_train_step(jcfg, jax_make_mesh(axes),
                                           learning_rate=LR, **kw)
    state = init_fn(jax.random.PRNGKey(0))
    states, losses = [jax.tree.map(np.asarray, state)], []
    for _ in range(steps):
        state, loss = step_fn(state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(loss))
    return dict(states=states, losses=losses, tokens=tokens,
                targets=targets)


@pytest.fixture(scope="module")
def sp_run():
    """tests/test_parallel.py:66-82: JAX's step at dp 2 × tp 2 × sp 2
    with use_sp, three steps on one batch."""
    jcfg, _ = _configs()
    tokens, targets = _batch(jcfg.vocab_size, 1)
    return _jax_steps(jcfg, SP_AXES, tokens, targets, STEPS, use_sp=True)


def _check_state(state, want, first_mu):
    """The port's state against a JAX state: moments tightly, the params
    as the module docstring says."""
    adam, jadam = state.opt_state[0], want.opt_state[0]
    for name, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
        got, ref = _np(getattr(adam, name)), _np(getattr(jadam, name))
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key],
                                       err_msg=f"{name} {key}", **tol)
    last = _np(jadam.mu)
    got, ref = _np(state.params), _np(want.params)
    steps = int(want.step)
    for key in ref:
        delta = np.abs(got[key] - ref[key])
        tight = settled(first_mu[key]) & settled(last[key])
        assert delta[tight].max() <= PARAM_TIGHT, key
        assert delta.max() <= 2 * LR * steps, key


def test_dp_tp_sp_train_step_tracks_jax(sp_run):
    """Three steps of the port's mesh step from JAX's initial mesh state:
    loss for loss, step 3, the moments and params, and ``wq`` still
    column-parallel on tp."""
    _, pcfg = _configs()
    mesh = make_mesh(SP_AXES, cpus())
    _, step_fn = make_train_step(pcfg, mesh, learning_rate=LR, use_sp=True,
                                 device="cpu")
    state = from_jax_train_state(sp_run["states"][0], mesh=mesh)
    assert state.params["layers"]["wq"].spec == P(None, None, "tp")
    for i in range(STEPS):
        state, loss = step_fn(state, sp_run["tokens"], sp_run["targets"])
        assert loss.dim() == 0 and loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss), sp_run["losses"][i],
                                   rtol=LOSS_RTOL)
    assert sp_run["losses"][-1] < sp_run["losses"][0]
    assert int(state.step) == int(sp_run["states"][-1].step) == STEPS
    assert int(state.opt_state[0].count) == STEPS
    assert state.params["layers"]["wq"].spec == P(None, None, "tp")
    assert state.opt_state[0].mu["layers"]["wq"].spec == P(None, None, "tp")
    assert state.params["layers"]["wq"].shard((0, 1, 0)).shape == (2, 64, 32)
    _check_state(state, sp_run["states"][-1],
                 _np(sp_run["states"][1].opt_state[0].mu))


def test_loss_fn_over_a_mesh_matches_jax(sp_run):
    """``llama.loss_fn(mesh=)`` of plain params (ring attention over sp,
    batch on dp, heads on tp) is JAX's first mesh loss, and its
    gradients, through ring attention's writes of its output blocks,
    are JAX's first step's: optax's first moment is ``(1 - b1)·g``."""
    _, pcfg = _configs()
    params = from_jax_llama(sp_run["states"][0].params, "cpu")
    mesh = make_mesh(SP_AXES, cpus())
    loss, grads = pt_train.value_and_grad(
        lambda p, t, y: pt_llama.loss_fn(p, pcfg, t, y, mesh=mesh), params,
        torch.as_tensor(sp_run["tokens"]),
        torch.as_tensor(sp_run["targets"]))
    np.testing.assert_allclose(float(loss), sp_run["losses"][0],
                               rtol=LOSS_RTOL)
    want = _np(sp_run["states"][1].opt_state[0].mu)
    got = _np(grads)
    for key in want:
        assert np.abs(got[key]).max() > 0, key
        np.testing.assert_allclose(got[key], want[key] / np.float32(0.1),
                                   err_msg=key, **GRAD_TOL)
    plain = pt_llama.loss_fn(params, pcfg, torch.as_tensor(sp_run["tokens"]),
                             torch.as_tensor(sp_run["targets"]))
    np.testing.assert_allclose(float(loss), float(plain), rtol=LOSS_RTOL)


def test_remat_over_dp_equals_the_plain_step():
    """tests/test_parallel.py:84-93 at dp 2: remat's two steps are the
    plain step's, bit for bit."""
    _, pcfg = _configs()
    mesh = make_mesh({"dp": 2}, cpus(2))
    tokens, targets = _batch(pcfg.vocab_size, 4, (2, 16))
    runs = []
    for remat in (False, True):
        init_fn, step_fn = make_train_step(pcfg, mesh, remat=remat,
                                           device="cpu")
        state = init_fn(5)
        losses = [float(step_fn(state, tokens, targets)[1])
                  for _ in range(2)]
        runs.append((losses, _np(state)))
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0]).all()
    for key, value in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][key], value, err_msg=key)


def test_tp4_over_gqa_tracks_jax():
    """Dry-run phase 7 (``__graft_entry__.py:277-286``): tiny at GQA 16:4
    over dp 2 × tp 4 (each rank 4 query heads and 1 kv head), one step
    from JAX's initial state."""
    jcfg, pcfg = _configs(n_heads=16, n_kv_heads=4)
    axes = {"dp": 2, "tp": 4}
    tokens, targets = _batch(jcfg.vocab_size, 6, (2, 16))
    run = _jax_steps(jcfg, axes, tokens, targets, 1)
    mesh = make_mesh(axes, cpus())
    _, step_fn = make_train_step(pcfg, mesh, learning_rate=LR, device="cpu")
    state = from_jax_train_state(run["states"][0], mesh=mesh)
    assert state.params["layers"]["wk"].shard((1, 3)).shape == (2, 64, 4)
    state, loss = step_fn(state, tokens, targets)
    np.testing.assert_allclose(float(loss), run["losses"][0], rtol=LOSS_RTOL)
    assert float(loss) < np.log(pcfg.vocab_size) + 1
    _check_state(state, run["states"][1],
                 _np(run["states"][1].opt_state[0].mu))


@pytest.mark.parametrize("use_flash", [False, True])
def test_eval_step_over_a_mesh_matches_jax(sp_run, use_flash):
    """``make_eval_step(cfg, mesh)`` at dp 2 × tp 2 (JAX's ``P("dp")``
    batch, no sp) on the state after the last step, sharded and plain
    params alike; with ``use_flash`` each rank's attention is the flash
    wrapper's plain version on the CPU."""
    jcfg, _ = _configs()
    axes = {"dp": 2, "tp": 2}
    state = sp_run["states"][-1]
    want = float(jax_make_eval_step(jcfg, jax_make_mesh(axes))(
        state.params, jnp.asarray(sp_run["tokens"]),
        jnp.asarray(sp_run["targets"])))
    cfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=use_flash)
    mesh = make_mesh(axes, cpus(4))
    eval_fn = make_eval_step(cfg, mesh, device="cpu")
    for params in (from_jax_llama(state.params, mesh=mesh),
                   from_jax_llama(state.params, "cpu")):
        got = eval_fn(params, sp_run["tokens"], sp_run["targets"])
        assert not got.requires_grad
        np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def moe_case():
    """MoE ``tiny`` (4 experts) at float32 on an input whose capacity
    overflows (one row a single repeated token); JAX's forward and
    ``value_and_grad`` over dp 2 × ep 2 × tp 2 (tests/test_moe.py:45-57),
    and its unsharded forward."""
    jcfg = jax_moe.config("tiny", base=_configs()[0])
    params = jax.tree.map(np.asarray, jax_moe.init(jcfg,
                                                   jax.random.PRNGKey(0)))
    tokens, targets = _batch(jcfg.base.vocab_size, 3, (2, 16))
    tokens[1] = tokens[1, 0]
    jmesh = jax_make_mesh({"dp": 2, "ep": 2, "tp": 2})
    sharded = jax_shard_pytree(params, jmesh,
                               jax_prune_specs(jax_moe_specs(), jmesh))
    logits, aux = jax.jit(lambda p, t: jax_moe.forward(p, jcfg, t))(
        sharded, jnp.asarray(tokens))
    plain, _ = jax.jit(lambda p, t: jax_moe.forward(p, jcfg, t))(
        params, jnp.asarray(tokens))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_moe.loss_fn(p, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(targets))))(sharded)
    return dict(params=params, tokens=tokens, targets=targets,
                logits=np.asarray(logits), aux=float(aux),
                plain=np.asarray(plain), loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                drops=[float(d) for d in jax.jit(
                    lambda p, t: _jax_drops(p, jcfg, t))(
                        params, jnp.asarray(tokens))])


def _jax_drops(params, cfg, tokens):
    """Each layer's dropped tokens in JAX's MoE forward: its body
    (``gofr_tpu/models/moe.py`` ``forward``) layer by layer, a dropped
    token being an all-zero row of ``_moe_ffn``'s output."""
    base = cfg.base
    b, s = tokens.shape
    cos, sin = rope_table(base.max_seq_len, base.head_dim, base.rope_theta)
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    x = params["tok_emb"][tokens]
    drops = []
    for i in range(base.n_layers):
        layer = jax.tree.map(lambda w: w[i], params["layers"])
        h = rms_norm(x, layer["attn_norm"], base.norm_eps)
        q, k, v = jax_llama._qkv(layer, h, base, cos, sin, positions)
        x = x + prefill_attention(q, k, v).reshape(b, s, -1) @ layer["wo"]
        out, _ = jax_moe._moe_ffn(
            layer, rms_norm(x, layer["ffn_norm"], base.norm_eps), cfg)
        drops.append((out == 0).all(-1).sum())
        x = x + out
    return jnp.stack(drops)


def test_moe_over_ep_tp_matches_jax(moe_case):
    """The ep-sharded MoE at dp 2 × ep 2 × tp 2: logits against JAX's
    sharded and unsharded forwards, the aux loss, the loss and every
    gradient (routers' included) against JAX's ``value_and_grad`` over
    the sharded tree, and the dropped tokens of each layer against JAX's
    forward's and the unsharded port's."""
    pcfg = pt_moe.config("tiny", base=_configs()[1])
    mesh = make_mesh({"dp": 2, "ep": 2, "tp": 2}, cpus())
    params = from_jax_moe(moe_case["params"], mesh=mesh)
    assert params["layers"]["w_gate"].spec == P(None, "ep", None, "tp")
    assert params["layers"]["w_gate"].shard((0, 1, 1)).shape == (2, 2, 64,
                                                                 64)
    tokens = torch.as_tensor(moe_case["tokens"])
    drops, plain_drops = [], []
    logits, aux = pt_moe.forward(params, pcfg, tokens, drops)
    plain = pt_moe.forward(from_jax_moe(moe_case["params"], "cpu"), pcfg,
                           tokens, plain_drops)[0]
    for want in (moe_case["logits"], moe_case["plain"]):
        np.testing.assert_allclose(logits.detach().numpy(), want,
                                   **LOGITS_TOL)
    np.testing.assert_allclose(logits.detach().numpy(), plain.numpy(),
                               **LOGITS_TOL)
    np.testing.assert_allclose(float(aux), moe_case["aux"], rtol=LOSS_RTOL)
    counts = [float(d) for d in drops]
    assert counts == [float(d) for d in plain_drops] and sum(counts) > 0
    assert counts == moe_case["drops"]
    loss, grads = pt_train.value_and_grad(
        lambda p, t, y: pt_moe.loss_fn(p, pcfg, t, y), params, tokens,
        torch.as_tensor(moe_case["targets"]))
    np.testing.assert_allclose(float(loss), moe_case["loss"], rtol=LOSS_RTOL)
    want, got = _np(moe_case["grads"]), _np(grads)
    assert list(got) == list(want) and "layers/router" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)
    assert np.abs(got["layers/router"]).max() > 1e-4
    assert grads["layers"]["w_down"].spec == P(None, "ep", "tp", None)


def _shardings(mesh, specs):
    return sharding.map_specs(lambda _, spec: NamedSharding(mesh, spec),
                              specs, specs)


def test_jax_checkpoint_restores_onto_a_mesh(tmp_path):
    """tests/test_checkpoint.py:50-65 across packages: a bf16 JAX
    checkpoint restored with ``sharding=`` onto the port's dp 2 × tp 2
    mesh: the specs asked for, every shard the JAX leaf's slice bit for
    bit, and one ``NamedSharding`` for every leaf as well."""
    jparams = jax.tree.map(np.asarray, jax_llama.init(
        jax_llama.config("tiny"), jax.random.PRNGKey(0)))
    jax_save(str(tmp_path), jparams, step=0)
    like = pt_llama.init(pt_llama.config("tiny"), 0, device="cpu")
    mesh = make_mesh({"dp": 2, "tp": 2}, cpus(4))
    specs = sharding.prune_specs(sharding.llama_param_specs(), mesh)
    restored = restore_checkpoint(str(tmp_path), like,
                                  sharding=_shardings(mesh, specs))
    assert restored["layers"]["wq"].spec == P(None, None, "tp")
    want = tree_util.flatten(jparams)
    for key, leaf in tree_util.flatten(restored).items():
        assert leaf.dtype == torch.bfloat16
        full = want[key].astype(np.float32)
        for coord, shard in leaf.addressable_shards:
            cut = sharding.shard_slices(leaf.shape, mesh, leaf.spec, coord)
            np.testing.assert_array_equal(shard.float().numpy(), full[cut],
                                          err_msg=key)
    one = restore_checkpoint(str(tmp_path), like,
                             sharding=NamedSharding(mesh, P()))
    assert one["tok_emb"].spec == P()
    np.testing.assert_array_equal(one["tok_emb"].gather().float().numpy(),
                                  want["tok_emb"].astype(np.float32))


def test_sharded_port_checkpoint_reads_in_jax(tmp_path, sp_run):
    """The port's mesh state after three steps saved as full leaves:
    JAX's ``restore_checkpoint`` into its own state reads every leaf's
    bits and dtype."""
    _, pcfg = _configs()
    mesh = make_mesh(SP_AXES, cpus())
    _, step_fn = make_train_step(pcfg, mesh, use_sp=True, device="cpu")
    state = from_jax_train_state(sp_run["states"][0], mesh=mesh)
    state, _ = step_fn(state, sp_run["tokens"], sp_run["targets"])
    save_checkpoint(str(tmp_path), state, step=1)
    got = jax_restore(str(tmp_path), sp_run["states"][1])
    want = _np(state)
    for key, leaf in tree_util.flatten(
            jax.tree.map(np.asarray, got)).items():
        np.testing.assert_array_equal(leaf.astype(np.float32), want[key],
                                      err_msg=key)
    assert int(got.step) == 1


def test_resume_over_dp_equals_the_straight_run(tmp_path):
    """tests/test_checkpoint.py:68-92 at dp 2, here bit for bit: the
    whole state saved at step 2 and restored with ``sharding=`` (each
    leaf's own) takes step 3 as the uninterrupted run does; restored
    with ``device=`` its leaves are the gathered shards."""
    _, pcfg = _configs()
    mesh = make_mesh({"dp": 2}, cpus(2))
    tokens, targets = _batch(pcfg.vocab_size, 1, (2, 16))
    init_fn, step_fn = make_train_step(pcfg, mesh, device="cpu")
    state = init_fn(0)
    for _ in range(2):
        state, _ = step_fn(state, tokens, targets)
    save_checkpoint(str(tmp_path), state, step=2)
    state, loss_straight = step_fn(state, tokens, targets)
    fresh = init_fn(1)
    restored = restore_checkpoint(
        str(tmp_path), fresh,
        sharding=tree_util.tree_map(lambda leaf: leaf.sharding, fresh))
    assert int(restored.step) == 2
    assert isinstance(restored.opt_state[0].count, Sharded)
    restored, loss_resumed = step_fn(restored, tokens, targets)
    assert float(loss_resumed) == float(loss_straight)
    want, got = _np(state), _np(restored)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    plain = restore_checkpoint(str(tmp_path), fresh, device="cpu")
    assert isinstance(plain.params["tok_emb"], torch.Tensor)
    assert int(plain.step) == 2


def _assembled(state, mesh):
    """``state`` (a mesh state) rebuilt from each coordinate's own copy
    of its slice (``sharding.assemble``): no two coordinates share a
    tensor."""
    def rebuild(tree):
        flat = tree_util.flatten(tree)
        specs = {key: leaf.spec for key, leaf in flat.items()}
        full = {key: leaf.gather() for key, leaf in flat.items()}
        made = sharding.assemble(mesh, specs, lambda coord: {
            key: full[key][sharding.shard_slices(
                full[key].shape, mesh, specs[key], coord)].clone()
            for key in full})
        return tree_util.unflatten(tree, made)
    return pt_train.TrainState(rebuild(state.params),
                               pt_train.adamw_init(rebuild(state.params)),
                               rebuild(state.step))


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2}, {"dp": 2, "tp": 2}])
def test_distinct_copies_step_as_shared_ones(axes):
    """A state whose every coordinate holds its own tensors (as on four
    cards) against the same state with shards sharing the CPU, three
    steps: the replicas of each slice stay bit-equal. At dp 2 × sp 2
    each slice's gradient is two dp rows' parts, summed in float32 once
    either way, so every replica is the shared tensor's bits and the
    losses are equal; at dp 2 × tp 2 a replicated leaf sums four parts,
    in coordinate order apart and in autograd's order shared, so the two
    agree within the module's float32 tolerances."""
    _, pcfg = _configs()
    mesh = make_mesh(axes, cpus(4))
    tokens, targets = _batch(pcfg.vocab_size, 2, (2, 16))
    init_fn, step_fn = make_train_step(pcfg, mesh, use_sp=True, device="cpu")
    shared = init_fn(3)
    apart = _assembled(shared, mesh)
    norm = apart.params["layers"]["attn_norm"]
    assert len(norm.distinct_shards()) == 4
    assert len(shared.params["layers"]["attn_norm"].distinct_shards()) == 1
    exact = "sp" in axes
    for _ in range(STEPS):
        shared, loss_shared = step_fn(shared, tokens, targets)
        apart, loss_apart = step_fn(apart, tokens, targets)
        if exact:
            assert float(loss_shared) == float(loss_apart)
        np.testing.assert_allclose(float(loss_apart), float(loss_shared),
                                   rtol=LOSS_RTOL)
    want = tree_util.flatten(shared)
    for key, leaf in tree_util.flatten(apart).items():
        replicas = {}
        for coord, t in leaf.addressable_shards:
            cut = str(sharding.shard_slices(leaf.shape, mesh, leaf.spec,
                                            coord))
            assert torch.equal(t, replicas.setdefault(cut, t)), (key, coord)
            if exact:
                assert torch.equal(t, want[key].shard(coord)), (key, coord)
    if not exact:
        got, ref = _np(apart), _np(shared)
        for key in ref:
            if "/.mu/" in key:
                np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                           **MU_TOL)
            elif "/.nu/" in key:
                np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                           **NU_TOL)
    assert int(apart.step) == STEPS


def test_a_step_changes_each_distinct_tensor_once(monkeypatch):
    """Over dp 2 × tp 2 on one device every coordinate of a tp rank
    shares that rank's tensor: the AdamW step runs once a distinct
    param tensor (replicated leaves: one for all four coordinates), not
    once a coordinate; the caller's tree is never the state's."""
    _, pcfg = _configs()
    mesh = make_mesh({"dp": 2, "tp": 2}, cpus(4))
    tokens, targets = _batch(pcfg.vocab_size, 5, (2, 16))
    plain = pt_llama.init(pcfg, 0, device="cpu")
    before = {key: leaf.clone() for key, leaf in
              tree_util.flatten(plain).items()}
    state = shard_train_state(pt_train.TrainState(
        plain, pt_train.adamw_init(plain),
        torch.zeros((), dtype=torch.int32)), mesh)
    _, step_fn = make_train_step(pcfg, mesh, device="cpu")
    seen = []
    leaf_step = pt_train._adamw_leaf
    monkeypatch.setattr(pt_train, "_adamw_leaf",
                        lambda p, *a: seen.append(id(p)) or leaf_step(p, *a))
    step_fn(state, tokens, targets)
    distinct = [id(t) for leaf in tree_util.flatten(state.params).values()
                for t in leaf.distinct_shards()]
    assert len(seen) == len(set(seen)) == len(distinct) == 4 + 8 * 2
    assert set(seen) == set(distinct)
    assert len(state.params["tok_emb"].distinct_shards()) == 1
    for key, leaf in tree_util.flatten(plain).items():
        assert torch.equal(leaf, before[key]), key
    changed = _np(state.params)
    assert all(np.abs(changed[k] - before[k].numpy()).max() > 0
               for k in changed)


def test_train_step_refuses_what_is_not_a_mesh():
    _, pcfg = _configs()
    for fn in (make_train_step, make_eval_step):
        with pytest.raises(ValueError, match="mesh"):
            fn(pcfg, mesh={"dp": 2}, device="cpu")
    flash = dataclasses.replace(pcfg, use_flash=True)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(flash, make_mesh({"dp": 2}, cpus(2)), device="cpu")
