"""SPMD parallelism over the port's single-controller meshes (counterpart
of ``gofr_tpu/parallel``): dp/tp/sp/pp for serving, and the train and
eval steps on one device or over a dp × tp × sp mesh. JAX annotates
shardings and XLA inserts the collectives; here each shard is a tensor
of its own and the collectives are explicit (``parallel/collectives``)."""

from gofr_tpu_torch.parallel.mesh import (Mesh, make_mesh, parse_mesh_spec,
                                          serving_mesh)
from gofr_tpu_torch.parallel.pipeline import make_pp_forward
from gofr_tpu_torch.parallel.ring_attention import ring_attention
from gofr_tpu_torch.parallel.sharding import (
    P,
    batch_spec,
    bert_param_specs,
    gather_pytree,
    llama_cache_specs,
    llama_param_specs,
    moe_param_specs,
    prune_specs,
    replicated_specs,
    shard_pytree,
)
from gofr_tpu_torch.parallel.train import (TrainState, make_eval_step,
                                           make_train_step,
                                           shard_train_state)

__all__ = [
    "make_mesh", "parse_mesh_spec", "serving_mesh", "ring_attention",
    "batch_spec", "bert_param_specs", "llama_cache_specs",
    "llama_param_specs", "prune_specs", "replicated_specs", "shard_pytree",
    "TrainState", "make_eval_step", "make_train_step", "make_pp_forward",
    "Mesh", "P", "gather_pytree", "moe_param_specs", "shard_train_state",
]
