"""Training: AdamW with float32 master weights (:mod:`.optimizer`) and the
microbatched train step (:mod:`.train_step`)."""

from .optimizer import (OptimizerConfig, adamw_update, cosine_lr,
                        global_norm, init_compress_state, init_opt_state,
                        quantize_int8)
from .train_step import (TrainConfig, check_trainable, grad_fn,
                         init_train_state, make_train_step, micro_loss)

__all__ = ["OptimizerConfig", "TrainConfig", "adamw_update",
           "check_trainable", "cosine_lr",
           "global_norm", "grad_fn", "init_compress_state", "init_opt_state",
           "init_train_state", "make_train_step", "micro_loss",
           "quantize_int8"]
