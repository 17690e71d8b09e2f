"""Training (counterpart of ``gofr_tpu/parallel``): the train and eval
steps on one device. The meshes, shardings, ring attention and pipeline
of the JAX package's ``parallel/`` are not ported."""

from gofr_tpu_torch.parallel.train import (TrainState, make_eval_step,
                                           make_train_step)

__all__ = ["TrainState", "make_eval_step", "make_train_step"]
