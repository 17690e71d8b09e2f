"""The training step on one device (counterpart of
``gofr_tpu/parallel/train.py``).

- :func:`make_train_step` returns ``(init_fn, step_fn)``: ``init_fn(seed)``
  draws ``llama.init``'s params and zero Adam moments on the device;
  ``step_fn(state, tokens, targets)`` takes the gradient of
  ``llama.loss_fn`` by autograd and applies optax's ``adamw`` in place
  (the port's form of JAX's state donation), returning ``(state, loss)``.
- The optimizer is optax 0.2.6's ``adamw`` step for step
  (:func:`adamw_update`): its defaults (weight decay 1e-4 on every
  leaf, norms and the embedding too), its order of operations, moments
  in the param dtype, its constants rounded to that dtype as JAX rounds
  a Python scalar. Its state is optax's, ``(ScaleByAdamState(count,
  mu, nu), EmptyState(), EmptyState())``, so a ``TrainState``
  checkpoints under JAX's keys (``utils/checkpoint``).
- Attention in the train step is the plain causal attention, which
  autograd differentiates, as JAX differentiates its dense
  ``prefill_attention``: the Pallas flash kernel has no backward, and
  neither has the port's CUDA kernel, so ``cfg.use_flash`` is refused.
  The eval step (no gradient) runs the flash kernel on the card when
  ``cfg.use_flash`` is set.
- One device: ``mesh`` raises ValueError (``parallel/``'s meshes are not
  ported); ``use_sp`` without a mesh changes nothing, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch
import torch.utils.checkpoint

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.utils import tree as tree_util


class ScaleByAdamState(NamedTuple):
    """optax's Adam state: the step count (int32, 0-d) and the first and
    second moments, trees of the params' shapes and dtypes."""
    count: torch.Tensor
    mu: Any
    nu: Any


AdamState = ScaleByAdamState


class EmptyState(NamedTuple):
    """The state of optax's weight decay and learning-rate scaling."""


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def adamw_init(params: Any) -> Tuple[ScaleByAdamState, EmptyState,
                                     EmptyState]:
    """optax ``adamw(...).init``: count 0, zero moments like ``params``."""
    leaves = tree_util.flatten(params)
    device = next(iter(leaves.values())).device

    def zeros():
        return tree_util.unflatten(params, {
            key: torch.zeros_like(leaf) for key, leaf in leaves.items()})

    count = torch.zeros((), dtype=torch.int32, device=device)
    return (ScaleByAdamState(count, zeros(), zeros()), EmptyState(),
            EmptyState())


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: a weak
    type takes the array's dtype, so the constant is rounded to it first
    (b2 = 0.999 is 1.0 in bfloat16)."""
    return torch.tensor(x, dtype=dtype).item()


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Tuple, params: Any,
                 learning_rate: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4) -> None:
    """One optax ``adamw`` step, in place on ``params`` and the moments
    of ``opt_state``, each leaf in its own dtype and in optax's order:
    ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, ``count += 1``,
    ``u = (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count) + eps_root) + eps)
    + weight_decay·p``, ``p = p + (-lr)·u``. Each constant is rounded to
    the leaf's dtype (:func:`_weak`); the bias corrections are float32 on
    the device (no host sync), cast to each moment's dtype before the
    division, as optax casts them."""
    adam = opt_state[0]
    adam.count.add_(1)
    bc1 = 1 - b1 ** adam.count
    bc2 = 1 - b2 ** adam.count
    g_leaves = tree_util.flatten(grads)
    mu_leaves = tree_util.flatten(adam.mu)
    nu_leaves = tree_util.flatten(adam.nu)
    for key, p in tree_util.flatten(params).items():
        g, mu, nu = g_leaves[key], mu_leaves[key], nu_leaves[key]
        dt = p.dtype
        mu.mul_(_weak(b1, dt)).add_(g * _weak(1 - b1, dt))
        nu.mul_(_weak(b2, dt)).add_(g * g * _weak(1 - b2, dt))
        u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)
                                            + _weak(eps_root, dt))
                                 + _weak(eps, dt))
        u.add_(_weak(weight_decay, dt) * p)
        p.add_(_weak(-learning_rate, dt) * u)


def value_and_grad(loss: Callable[..., torch.Tensor], params: Any, *args,
                   remat: bool = False) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(loss)(params, *args)``: the loss (detached)
    and a tree of gradients like ``params``. The params are not touched:
    autograd runs over detached views of their leaves. ``remat`` wraps
    the whole loss in ``torch.utils.checkpoint.checkpoint``
    (``jax.checkpoint(loss)``): no activation is kept between the forward
    and the backward, which runs the forward again."""
    leaves = {key: leaf.detach().requires_grad_()
              for key, leaf in tree_util.flatten(params).items()}
    inputs = tree_util.unflatten(params, leaves)
    if remat:
        value = torch.utils.checkpoint.checkpoint(
            loss, inputs, *args, use_reentrant=False)
    else:
        value = loss(inputs, *args)
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return value.detach(), tree_util.unflatten(
        params, dict(zip(leaves.keys(), grads)))


def _batch(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def _one_device(mesh) -> None:
    if mesh is not None:
        raise ValueError("mesh= is not ported (parallel/'s meshes and "
                         "shardings): the port trains on one device")


def make_train_step(cfg: llama.LlamaConfig, mesh=None,
                    learning_rate: float = 3e-4, use_sp: bool = False,
                    remat: bool = False,
                    device: Union[str, torch.device] = "cuda"):
    """Returns ``(init_fn, step_fn)``.

    ``init_fn(seed)`` → :class:`TrainState` with ``llama.init(cfg, seed)``
    params and optax ``adamw`` state on ``device``, step 0.
    ``step_fn(state, tokens, targets)`` → ``(state, loss)``: one AdamW
    step at ``learning_rate`` on the gradient of ``llama.loss_fn``,
    updating ``state``'s tensors in place (the state passed in is the
    state returned). ``remat`` wraps the loss in a checkpoint
    (:func:`value_and_grad`). ``cfg.use_flash`` raises ValueError: the
    flash kernel has no backward (JAX's Pallas kernel neither)."""
    _one_device(mesh)
    del use_sp  # only meaningful over a mesh's sp axis
    if cfg.use_flash:
        raise ValueError("make_train_step: cfg.use_flash is refused; the "
                         "flash-attention kernel has no backward (the "
                         "Pallas kernel it replaces has none); train with "
                         "use_flash=False, evaluate with it")
    dev = resolve_device(device)

    def init_fn(seed: int) -> TrainState:
        params = llama.init(cfg, seed, device=dev)
        return TrainState(params, adamw_init(params),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def loss(params, tokens, targets):
        return llama.loss_fn(params, cfg, tokens, targets)

    def step_fn(state: TrainState, tokens: Any, targets: Any
                ) -> Tuple[TrainState, torch.Tensor]:
        loss_val, grads = value_and_grad(loss, state.params,
                                         _batch(tokens, dev),
                                         _batch(targets, dev), remat=remat)
        adamw_update(grads, state.opt_state, state.params, learning_rate)
        state.step.add_(1)
        return state, loss_val

    return init_fn, step_fn


def make_eval_step(cfg: llama.LlamaConfig, mesh=None,
                   device: Union[str, torch.device] = "cuda"):
    """``eval_fn(params, tokens, targets)`` → the mean loss, under
    ``torch.no_grad()``; with ``cfg.use_flash`` on the card attention
    goes through the flash kernel."""
    _one_device(mesh)
    dev = resolve_device(device)

    def eval_fn(params, tokens, targets) -> torch.Tensor:
        with torch.no_grad():
            return llama.loss_fn(params, cfg, _batch(tokens, dev),
                                 _batch(targets, dev))

    return eval_fn
