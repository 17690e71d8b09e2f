"""The training step, on one device or over a mesh (counterpart of
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
- Over a ``mesh`` (dp × tp × sp, JAX's axes) every leaf of the state is
  a ``parallel/sharding.Sharded``: the params by
  ``prune_specs(llama_param_specs(), mesh)``, the moments in the
  params' layout (:func:`adamw_init` maps over each leaf's distinct
  tensors), count and step replicated 0-d leaves. The batch is cut on
  dp (``llama._mesh_rows``: each row through its tp line, one
  all-reduce after ``wo`` and ``w_down``), with ``use_sp`` on the sp
  axis inside attention (each (dp, tp) coordinate's own ring); the loss
  is the mean NLL over the whole global batch. :func:`value_and_grad`
  detaches each distinct tensor once, so coordinates sharing one (dp
  rows on one device) accumulate into one gradient, JAX's psum over dp;
  copies held apart (distinct devices) have their gradients summed
  (``sharding.sum_replicas``) and step alike. :func:`adamw_update`
  walks distinct tensors, each stepped exactly once. The state owns its
  memory: it never shares a tensor with the caller's tree. The mesh's
  devices are the state's; ``device`` serves the one-device step.
- ``use_sp`` without a mesh, or over a mesh without an sp axis, changes
  nothing, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch
import torch.utils.checkpoint

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.parallel import sharding
from gofr_tpu_torch.parallel.mesh import Mesh
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
    """optax ``adamw(...).init``: count 0, zero moments like ``params``
    (over a tree of ``Sharded`` leaves, in its layout, the count a
    replicated 0-d leaf on its mesh)."""
    first = next(iter(tree_util.flatten(params).values()))

    def zeros():
        return sharding.map_distinct_tree(torch.zeros_like, params)

    if isinstance(first, sharding.Sharded):
        count = sharding.shard_leaf(
            torch.zeros((), dtype=torch.int32,
                        device=first.distinct_shards()[0].device),
            first.mesh, sharding.P())
    else:
        count = torch.zeros((), dtype=torch.int32, device=first.device)
    return (ScaleByAdamState(count, zeros(), zeros()), EmptyState(),
            EmptyState())


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: a weak
    type takes the array's dtype, so the constant is rounded to it first
    (b2 = 0.999 is 1.0 in bfloat16)."""
    return torch.tensor(x, dtype=dtype).item()


def _adamw_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                learning_rate: float, b1: float, b2: float, eps: float,
                eps_root: float, weight_decay: float) -> None:
    """One tensor's optax ``adamw`` step, in place (:func:`adamw_update`)."""
    dt = p.dtype
    mu.mul_(_weak(b1, dt)).add_(g * _weak(1 - b1, dt))
    nu.mul_(_weak(b2, dt)).add_(g * g * _weak(1 - b2, dt))
    u = (mu / bc1.to(dt)) / (torch.sqrt(nu / bc2.to(dt)
                                        + _weak(eps_root, dt))
                             + _weak(eps, dt))
    u.add_(_weak(weight_decay, dt) * p)
    p.add_(_weak(-learning_rate, dt) * u)


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
    division, as optax casts them. Over ``Sharded`` leaves (params,
    grads and moments in one layout) each distinct tensor is stepped
    exactly once, however many mesh coordinates hold it."""
    adam = opt_state[0]
    counts = sharding.distinct_tensors(adam.count)
    corrections: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for count in counts:
        count.add_(1)
        corrections[str(count.device)] = (1 - b1 ** count, 1 - b2 ** count)
    g_leaves = tree_util.flatten(grads)
    mu_leaves = tree_util.flatten(adam.mu)
    nu_leaves = tree_util.flatten(adam.nu)
    for key, leaf in tree_util.flatten(params).items():
        for p, g, mu, nu in _by_param(leaf, g_leaves[key], mu_leaves[key],
                                      nu_leaves[key]):
            bc1, bc2 = corrections.get(str(p.device)) or tuple(
                c.to(p.device) for c in corrections[str(counts[0].device)])
            _adamw_leaf(p, g, mu, nu, bc1, bc2, learning_rate, b1, b2,
                        eps, eps_root, weight_decay)


def _by_param(p: Any, *others: Any):
    """(p, *others' tensors) for each distinct tensor p of a param leaf,
    the others' taken at the coordinate first holding p (a gradient
    may be one tensor where replicas of p are several)."""
    if not isinstance(p, sharding.Sharded):
        yield (p,) + others
        return
    seen = set()
    for coord in p.mesh.coords():
        t = p.shards[coord]
        if id(t) not in seen:
            seen.add(id(t))
            yield (t,) + tuple(o.shards[coord] for o in others)


def value_and_grad(loss: Callable[..., torch.Tensor], params: Any, *args,
                   remat: bool = False) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(loss)(params, *args)``: the loss (detached)
    and a tree of gradients like ``params``. The params are not touched:
    autograd runs over detached views of their leaves, over each
    distinct tensor of a ``Sharded`` leaf once (coordinates sharing it
    accumulate into one gradient), and the gradients of copies of one
    slice held apart are summed (``sharding.sum_replicas``), so the
    gradient tree has the params' layout. ``remat`` wraps the whole loss
    in ``torch.utils.checkpoint.checkpoint`` (``jax.checkpoint(loss)``):
    no activation is kept between the forward and the backward, which
    runs the forward again."""
    detached: List[torch.Tensor] = []

    def detach(t):
        d = t.detach().requires_grad_()
        detached.append(d)
        return d

    inputs = sharding.map_distinct_tree(detach, params)
    if remat:
        value = torch.utils.checkpoint.checkpoint(
            loss, inputs, *args, use_reentrant=False)
    else:
        value = loss(inputs, *args)
    grads = torch.autograd.grad(value, detached, allow_unused=True,
                                materialize_grads=True)
    by_id = {id(d): g for d, g in zip(detached, grads)}
    return value.detach(), tree_util.tree_map(
        lambda leaf: sharding.sum_replicas(sharding.map_distinct(
            lambda d: by_id[id(d)], leaf)), inputs)


def _batch(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


def _mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh: expected a gofr_tpu_torch.parallel.mesh."
                         f"Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def _home(mesh: Mesh) -> torch.device:
    """The mesh's first device: where the batch arrives and the loss is
    returned."""
    return resolve_device(mesh.devices.flat[0])


def shard_train_state(state: TrainState, mesh: Mesh, specs: Any = None
                      ) -> TrainState:
    """A one-device :class:`TrainState` (or one whose leaves are numpy
    arrays or tensors anywhere) laid out on ``mesh``: params and both
    moments by ``specs`` (default ``prune_specs(llama_param_specs(),
    mesh)``), count and step replicated. Every shard is a copy: the new
    state never writes the given one's tensors."""
    mesh = _mesh(mesh)
    if specs is None:
        specs = sharding.prune_specs(sharding.llama_param_specs(), mesh)
    adam = state.opt_state[0]

    def lay(tree, tree_specs):
        return sharding.shard_pytree(tree_util.tree_map(torch.as_tensor,
                                                        tree),
                                     mesh, tree_specs, own=True)

    opt_state = (ScaleByAdamState(lay(adam.count, sharding.P()),
                                  lay(adam.mu, specs), lay(adam.nu, specs)),
                 ) + tuple(state.opt_state[1:])
    return TrainState(lay(state.params, specs), opt_state,
                      lay(state.step, sharding.P()))


def make_train_step(cfg: llama.LlamaConfig, mesh=None,
                    learning_rate: float = 3e-4, use_sp: bool = False,
                    remat: bool = False,
                    device: Union[str, torch.device] = "cuda"):
    """Returns ``(init_fn, step_fn)``.

    ``init_fn(seed)`` → :class:`TrainState` with ``llama.init(cfg, seed)``
    params and optax ``adamw`` state, step 0: on ``device``, or over
    ``mesh`` (drawn on its first device, then laid out as the module
    docstring says). ``step_fn(state, tokens, targets)`` → ``(state,
    loss)``: one AdamW step at ``learning_rate`` on the gradient of
    ``llama.loss_fn``, updating ``state``'s tensors in place (the state
    passed in is the state returned); over a mesh the batch is cut on dp
    (and with ``use_sp`` attention on sp, JAX's ``P("dp", "sp")``) and
    the loss is the mean over the global batch. ``remat`` wraps the loss
    in a checkpoint (:func:`value_and_grad`). ``cfg.use_flash`` raises
    ValueError: the flash kernel has no backward (JAX's Pallas kernel
    neither); so does a ``mesh`` that is not a ``Mesh``."""
    if mesh is not None:
        _mesh(mesh)
    if cfg.use_flash:
        raise ValueError("make_train_step: cfg.use_flash is refused; the "
                         "flash-attention kernel has no backward (the "
                         "Pallas kernel it replaces has none); train with "
                         "use_flash=False, evaluate with it")
    home = resolve_device(device) if mesh is None else _home(mesh)
    ring = mesh if mesh is not None and use_sp and "sp" in mesh.shape \
        else None

    def init_fn(seed: int) -> TrainState:
        params = llama.init(cfg, seed, device=home)
        step = torch.zeros((), dtype=torch.int32, device=home)
        if mesh is not None:
            params = sharding.shard_pytree(params, mesh, sharding.prune_specs(
                sharding.llama_param_specs(), mesh))
            step = sharding.shard_leaf(step, mesh, sharding.P())
        return TrainState(params, adamw_init(params), step)

    def loss(params, tokens, targets):
        return llama.loss_fn(params, cfg, tokens, targets, mesh=ring)

    def step_fn(state: TrainState, tokens: Any, targets: Any
                ) -> Tuple[TrainState, torch.Tensor]:
        loss_val, grads = value_and_grad(loss, state.params,
                                         _batch(tokens, home),
                                         _batch(targets, home), remat=remat)
        adamw_update(grads, state.opt_state, state.params, learning_rate)
        for step in sharding.distinct_tensors(state.step):
            step.add_(1)
        return state, loss_val

    return init_fn, step_fn


def make_eval_step(cfg: llama.LlamaConfig, mesh=None,
                   device: Union[str, torch.device] = "cuda"):
    """``eval_fn(params, tokens, targets)`` → the mean loss, under
    ``torch.no_grad()``; with ``cfg.use_flash`` on the card attention
    goes through the flash kernel. Over ``mesh`` (JAX's ``P("dp")``
    batch, no sp) the batch is cut on dp and each row runs through its
    tp line, the flash kernel at a rank's heads; params not yet on the
    mesh are laid out by ``prune_specs(llama_param_specs(), mesh)`` for
    the call."""
    if mesh is None:
        dev = resolve_device(device)
    else:
        mesh = _mesh(mesh)
        dev = _home(mesh)
        specs = sharding.prune_specs(sharding.llama_param_specs(), mesh)

    def eval_fn(params, tokens, targets) -> torch.Tensor:
        if mesh is not None and not sharding.is_sharded(params):
            params = sharding.shard_pytree(params, mesh, specs)
        with torch.no_grad():
            return llama.loss_fn(params, cfg, _batch(tokens, dev),
                                 _batch(targets, dev))

    return eval_fn
