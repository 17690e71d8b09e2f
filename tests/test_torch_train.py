"""Port parity for training on one device (``models/llama.loss_fn``,
``models/moe.loss_fn``, ``parallel/train``) against the JAX package on
the CPU, ``tiny`` at float32 unless a case says otherwise, inputs from a
numpy seed; JAX's train step runs on a one-device mesh.

Tolerances (float32; the two packages sum in other orders):
- losses within 1e-6 relative; gradients within 1e-6 absolute plus 1e-4
  relative, leaf by leaf (measured: at most 3e-7 against leaves of max
  |g| 0.03-1.5);
- after steps from the same state: the moments within 1e-4 relative
  plus 1e-7 absolute (mu) and 1e-9 (nu), which the gradients' own
  differences fill; params within 1e-5 where the first moment, after
  the first step and after the last, is above 1e-2 of its leaf's
  largest, and elsewhere within 2·lr a step: where a gradient is
  rounding noise, Adam's first steps ``mû/√ν̂`` take either sign at full
  size;
- the optimizer alone: at bfloat16 optax's bits exactly (each constant
  rounded to bf16 as JAX rounds a weak-typed scalar), at float32 within
  1e-6 relative, of each element or of the leaf's largest (XLA fuses
  ``(1-b)·g + b·m`` into a multiply-add, one rounding fewer);
- bfloat16 training: the first loss within 2e-2 relative, and both
  trajectories fall.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.models import moe as jax_moe
from gofr_tpu.parallel import make_eval_step as jax_make_eval_step
from gofr_tpu.parallel import make_mesh
from gofr_tpu.parallel import make_train_step as jax_make_train_step
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import (from_jax_llama,
                                           from_jax_train_state)
from gofr_tpu_torch.parallel import (TrainState, make_eval_step,
                                     make_train_step)
from gofr_tpu_torch.parallel import train as pt_train
from gofr_tpu_torch.utils import tree as tree_util

LR = 3e-4
STEPS = 3
LOSS_RTOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MU_TOL = dict(rtol=1e-4, atol=1e-7)
NU_TOL = dict(rtol=1e-4, atol=1e-9)
ONE_ROUNDING = 1e-6
PARAM_TIGHT = 1e-5


def _batch(cfg, seed, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, shape)
    return tokens, np.roll(tokens, -1, axis=1)


def _np(tree):
    return {key: (leaf.detach().float().numpy()
                  if isinstance(leaf, torch.Tensor)
                  else np.asarray(leaf, np.float32))
            for key, leaf in tree_util.flatten(tree).items()}


def settled(mu):
    """Where a first moment is above 1e-2 of its leaf's largest: there a
    gradient is no rounding noise, so Adam's step keeps its sign. The
    first step's moment decides (its update is the gradient's sign at
    full size), the last one's the rest."""
    return np.abs(mu) > 1e-2 * np.abs(mu).max()


def _configs(dtype=("float32",)):
    jdt, pdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype[0]]
    return (jax_llama.config("tiny", dtype=jdt),
            pt_llama.config("tiny", dtype=pdt))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's make_train_step on a one-device mesh: the initial state and
    the state and loss after each of STEPS steps on one batch."""
    jcfg, _ = _configs()
    init_fn, step_fn = jax_make_train_step(jcfg, make_mesh({"dp": 1}),
                                           learning_rate=LR)
    state = init_fn(jax.random.PRNGKey(0))
    tokens, targets = _batch(jcfg, 1)
    states = [jax.tree.map(np.asarray, state)]
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        states.append(jax.tree.map(np.asarray, state))
        losses.append(float(loss))
    return dict(states=states, losses=losses, tokens=tokens,
                targets=targets)


def test_llama_loss_and_grads_match_jax(jax_run):
    jcfg, pcfg = _configs()
    params_np = jax_run["states"][0].params
    tokens, targets = jax_run["tokens"], jax_run["targets"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jcfg, jnp.asarray(tokens),
                                    jnp.asarray(targets))))(params_np)
    ploss, pgrads = pt_train.value_and_grad(
        lambda p, t, y: pt_llama.loss_fn(p, pcfg, t, y),
        from_jax_llama(params_np, "cpu"), torch.as_tensor(tokens),
        torch.as_tensor(targets))
    assert ploss.dtype == torch.float32 and ploss.dim() == 0
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    want, got = _np(jax.tree.map(np.asarray, jgrads)), _np(pgrads)
    assert list(got) == list(want) and len(got) == 12
    for key in want:
        assert np.abs(want[key]).max() > 0, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def test_llama_forward_refuses_a_mesh():
    """``forward(mesh=)`` is served (ring attention over the sp axis, the
    unsharded forward's logits within 1e-5 at f32), and so is
    ``loss_fn(mesh=)`` (the unsharded loss within 1e-6 relative); a
    non-mesh object is refused by both."""
    from gofr_tpu_torch.parallel import make_mesh

    _, pcfg = _configs()
    pcfg = dataclasses.replace(pcfg, dtype=torch.float32)
    params = pt_llama.init(pcfg, 0, device="cpu")
    tokens = torch.arange(16, dtype=torch.long).reshape(2, 8) % 7
    mesh = make_mesh({"sp": 2}, [torch.device("cpu")] * 2)
    np.testing.assert_allclose(
        pt_llama.forward(params, pcfg, tokens, mesh=mesh).numpy(),
        pt_llama.forward(params, pcfg, tokens).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="mesh"):
        pt_llama.forward(params, pcfg, tokens, mesh=object())
    np.testing.assert_allclose(
        float(pt_llama.loss_fn(params, pcfg, tokens, tokens, mesh=mesh)),
        float(pt_llama.loss_fn(params, pcfg, tokens, tokens)),
        rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="mesh"):
        pt_llama.loss_fn(params, pcfg, tokens, tokens, mesh=object())


def test_moe_loss_grads_and_drops_match_jax():
    """MoE ``tiny`` (4 experts) on an input whose capacity overflows: the
    loss with its aux term, every gradient (the router's included), and
    the dropped tokens of each layer, which JAX's ``_moe_ffn`` shows as
    all-zero output rows."""
    jcfg = jax_moe.config("tiny", base=_configs()[0])
    pcfg = pt_moe.config("tiny", base=_configs()[1])
    jparams = jax.tree.map(np.asarray,
                           jax_moe.init(jcfg, jax.random.PRNGKey(0)))
    pparams = from_jax_llama(jparams, "cpu")
    tokens, targets = _batch(pcfg, 2, (2, 32))
    tokens[1] = tokens[1, 0]            # one row a single repeated token
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_moe.loss_fn(p, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(targets))))(jparams)
    drops = []
    ploss, pgrads = pt_train.value_and_grad(
        lambda p, t, y: pt_moe.loss_fn(p, pcfg, t, y, drops), pparams,
        torch.as_tensor(tokens), torch.as_tensor(targets))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    want, got = _np(jax.tree.map(np.asarray, jgrads)), _np(pgrads)
    assert list(got) == list(want) and "layers/router" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)
    router = got["layers/router"]
    assert np.isfinite(router).all() and np.abs(router).max() > 1e-4

    # capacity drops, layer by layer, on a hidden state whose second row
    # repeats one vector: its 32 tokens go to one expert of capacity 20
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 32, pcfg.dim)).astype(np.float32)
    hidden[1] = hidden[1, 0]
    counts = [float(d) for d in drops]
    assert sum(counts) > 0
    for i in range(pcfg.n_layers):
        jlayer = jax.tree.map(lambda w: w[i], jparams["layers"])
        player = {k: v[i] for k, v in pparams["layers"].items()}
        jout, _ = jax.jit(jax_moe._moe_ffn, static_argnums=2)(
            jlayer, jnp.asarray(hidden), jcfg)
        layer_drops = []
        pout, _ = pt_moe._moe_ffn(player, torch.as_tensor(hidden), pcfg,
                                  layer_drops)
        jzero = (np.asarray(jout) == 0).all(-1)
        pzero = (pout.numpy() == 0).all(-1)
        np.testing.assert_array_equal(pzero, jzero)
        assert float(layer_drops[0]) == jzero.sum() > 0


def test_steps_from_a_jax_state_track_jax(jax_run):
    """STEPS steps of the port's ``step_fn`` from ``from_jax_train_state``
    of JAX's initial state, on JAX's batch: loss for loss, count and step,
    the moments tightly, the params as the module docstring says."""
    _, pcfg = _configs()
    _, step_fn = make_train_step(pcfg, learning_rate=LR, device="cpu")
    state = from_jax_train_state(jax_run["states"][0], "cpu")
    assert isinstance(state, TrainState)
    for i in range(STEPS):
        state, loss = step_fn(state, jax_run["tokens"], jax_run["targets"])
        np.testing.assert_allclose(float(loss), jax_run["losses"][i],
                                   rtol=LOSS_RTOL)
        want = jax_run["states"][i + 1]
        assert int(state.step) == int(want.step) == i + 1
        assert int(state.opt_state[0].count) == int(want.opt_state[0].count)
    assert jax_run["losses"][-1] < jax_run["losses"][0]
    want = jax_run["states"][-1]
    adam, jadam = state.opt_state[0], want.opt_state[0]
    for name, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
        got, ref = _np(getattr(adam, name)), _np(getattr(jadam, name))
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key],
                                       err_msg=f"{name} {key}", **tol)
    first, last = _np(jax_run["states"][1].opt_state[0].mu), _np(jadam.mu)
    got, ref = _np(state.params), _np(want.params)
    for key in ref:
        delta = np.abs(got[key] - ref[key])
        tight = settled(first[key]) & settled(last[key])
        assert delta[tight].max() <= PARAM_TIGHT, key
        assert delta.max() <= 2 * LR * STEPS, key


def test_remat_equals_the_plain_step():
    _, pcfg = _configs()
    tokens, targets = _batch(pcfg, 4)
    runs = []
    for remat in (False, True):
        init_fn, step_fn = make_train_step(pcfg, remat=remat, device="cpu")
        state = init_fn(5)
        losses = [float(step_fn(state, tokens, targets)[1])
                  for _ in range(2)]
        runs.append((losses, _np(state)))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][key], value, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_is_optax_adamw(dtype):
    """``adamw_update`` against ``optax.adamw(3e-4)`` (weight decay 1e-4
    on every leaf) over three steps of random gradients at three scales:
    bf16 bit for bit; float32 within one rounding (XLA's multiply-add)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(7)
    params = {"b": (rng.standard_normal((8,)) * 0.5).astype(np.float32),
              "w": (rng.standard_normal((32, 48)) * 0.05).astype(np.float32)}
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    opt = optax.adamw(3e-4)
    jstate = opt.init(jparams)
    update = jax.jit(opt.update)
    pparams = {k: torch.tensor(v).to(tdt) for k, v in params.items()}
    pstate = pt_train.adamw_init(pparams)
    assert [type(s).__name__ for s in pstate] == [
        type(s).__name__ for s in jstate]
    for scale in (1e-2, 1e-4, 3e-2):
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = update(
            jax.tree.map(lambda x: jnp.asarray(x, jdt), grads), jstate,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        pt_train.adamw_update({k: torch.tensor(v).to(tdt)
                               for k, v in grads.items()}, pstate, pparams)
    assert int(pstate[0].count) == int(jstate[0].count) == 3
    pairs = [(pparams, jparams), (pstate[0].mu, jstate[0].mu),
             (pstate[0].nu, jstate[0].nu)]
    for got, want in pairs:
        got, want = _np(got), _np(jax.tree.map(np.asarray, want))
        for key in want:
            if dtype == "bfloat16":
                np.testing.assert_array_equal(got[key], want[key])
            else:
                np.testing.assert_allclose(
                    got[key], want[key], rtol=ONE_ROUNDING,
                    atol=ONE_ROUNDING * np.abs(want[key]).max())


def test_bf16_training_tracks_jax():
    """``tiny`` at bfloat16 from one state: the first loss within 2e-2
    relative of JAX's, and both three-step trajectories fall."""
    jcfg, pcfg = _configs(("bfloat16",))
    init_fn, jstep = jax_make_train_step(jcfg, make_mesh({"dp": 1}))
    jstate = init_fn(jax.random.PRNGKey(0))
    pstate = from_jax_train_state(jax.tree.map(np.asarray, jstate), "cpu")
    assert pstate.params["lm_head"].dtype == \
        torch.bfloat16
    _, pstep = make_train_step(pcfg, device="cpu")
    tokens, targets = _batch(pcfg, 6)
    jlosses, plosses = [], []
    for _ in range(STEPS):
        jstate, jloss = jstep(jstate, jnp.asarray(tokens),
                              jnp.asarray(targets))
        pstate, ploss = pstep(pstate, tokens, targets)
        jlosses.append(float(jloss))
        plosses.append(float(ploss))
    assert abs(plosses[0] - jlosses[0]) <= 2e-2 * jlosses[0]
    assert jlosses[-1] < jlosses[0] and plosses[-1] < plosses[0]


@pytest.mark.parametrize("use_flash", [False, True])
def test_eval_step_matches_jax(jax_run, use_flash):
    """``make_eval_step`` against JAX's on the state after the last step;
    with ``use_flash`` the port's CPU route is the flash wrapper's plain
    version (JAX's tiny head_dim 16 takes its dense fallback)."""
    jcfg, pcfg = _configs()
    state = jax_run["states"][-1]
    want = jax_make_eval_step(jcfg, make_mesh({"dp": 1}))(
        state.params, jnp.asarray(jax_run["tokens"]),
        jnp.asarray(jax_run["targets"]))
    cfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=use_flash)
    params = from_jax_llama(state.params, "cpu")
    got = make_eval_step(cfg, device="cpu")(params, jax_run["tokens"],
                                            jax_run["targets"])
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_train_step_refuses_flash_and_a_mesh():
    cfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, device="cpu")
    _, pcfg = _configs()
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(pcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_eval_step(pcfg, mesh=object(), device="cpu")
    # use_sp without a mesh changes nothing
    tokens, targets = _batch(pcfg, 8)
    losses = []
    for use_sp in (False, True):
        init_fn, step_fn = make_train_step(pcfg, use_sp=use_sp,
                                           device="cpu")
        losses.append(float(step_fn(init_fn(0), tokens, targets)[1]))
    assert losses[0] == losses[1]
