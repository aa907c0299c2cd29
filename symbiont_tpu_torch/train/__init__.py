"""Training in the port.

trainer    : the encoder fine-tune — InfoNCE with in-batch negatives over
             (query, passage) pairs, AdamW on float32 masters, through the
             CUDA flash-attention forward and backward kernels
checkpoint : params and train-state persistence, in the JAX package's
             on-disk format (a checkpoint of either package loads in the
             other)
"""

from symbiont_tpu_torch.train.trainer import (
    TrainState,
    contrastive_loss,
    contrastive_train_step,
    make_embedder_train_state,
)

__all__ = [
    "TrainState",
    "contrastive_loss",
    "contrastive_train_step",
    "make_embedder_train_state",
]
