"""Training in the port.

trainer    : the encoder fine-tune — InfoNCE with in-batch negatives over
             (query, passage) pairs — and the LM fine-tune — next-token
             cross-entropy — AdamW on float32 masters, through the CUDA
             flash-attention forward and backward kernels
online     : the online LM fine-tune over ingested text, synced into the
             serving LmEngine in place
checkpoint : params and train-state persistence, in the JAX package's
             on-disk format (a checkpoint of either package loads in the
             other)
"""

from symbiont_tpu_torch.train.online import OnlineLmTrainer
from symbiont_tpu_torch.train.trainer import (
    TrainState,
    contrastive_loss,
    contrastive_train_step,
    lm_loss,
    lm_train_step,
    make_embedder_train_state,
    make_lm_train_state,
)

__all__ = [
    "OnlineLmTrainer",
    "TrainState",
    "contrastive_loss",
    "contrastive_train_step",
    "lm_loss",
    "lm_train_step",
    "make_embedder_train_state",
    "make_lm_train_state",
]
