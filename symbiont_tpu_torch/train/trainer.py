"""The encoder fine-tune: a contrastive train step over (query, passage)
pairs.

The port of the embedder half of `symbiont_tpu/train/trainer.py`, with its
names (`TrainState`, `make_embedder_train_state`, `contrastive_loss`,
`contrastive_train_step`). The JAX package's pure-function step becomes
PyTorch's idiom: float32 master leaves with `requires_grad`, one backward,
and `torch.optim.AdamW` updating them in place. AdamW with betas (0.9,
0.999), eps 1e-8 and weight decay 0.01 on every leaf is the update of
`optax.adamw(lr, weight_decay=0.01)`: decoupled decay from the old value
plus the bias-corrected moment step, the same formula term by term.

`TrainState.opt_state` is the optimizer's own state (`tx.state`: per leaf
`step`, `exp_avg` = optax's `mu`, `exp_avg_sq` = `nu`), filled at creation
so a checkpoint can be restored into it before the first step.

With `cfg.attn_impl="flash"` the encoder's attention runs the CUDA
flash-attention forward and the fused backward kernels (dK/dV/dbias, dQ)
on CUDA tensors, their plain versions on CPU ones (`ops/flash_attention.py`).
The step runs where the params and batch live: the card unless the caller
hands it CPU tensors, as the tests do. The LM half of the JAX module
(`lm_loss`, `lm_train_step`, `shard_lm_train_state`) waits for the port's
GPT model (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from symbiont_tpu_torch.models import bert as bert_mod

Params = Any

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8
WEIGHT_DECAY = 0.01        # symbiont_tpu/train/trainer.py `_adamw`


class TrainState(NamedTuple):
    params: Params   # float32 master leaves, requires_grad
    opt_state: Any   # tx.state: {leaf: {"step", "exp_avg", "exp_avg_sq"}}
    step: int


def tree_leaves(tree) -> list:
    """Leaves in `jax.tree.leaves` order: dict keys sorted, lists in order.
    Checkpoints and the bridge line leaves up by this order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def make_embedder_train_state(params: Params, learning_rate: float = 1e-4
                              ) -> Tuple[TrainState, torch.optim.AdamW]:
    """float32 master copies of `params` (on their device) and the AdamW
    over them, its moments zero, as `optax.adamw(...).init` gives them."""
    masters = bert_mod.tree_map(
        lambda t: t.detach().to(torch.float32).clone().requires_grad_(), params)
    leaves = tree_leaves(masters)
    tx = torch.optim.AdamW(leaves, lr=learning_rate, betas=ADAM_BETAS,
                           eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)
    for p in leaves:
        # the layout AdamW builds lazily at its first step (step on the host)
        tx.state[p] = {"step": torch.tensor(0.0, dtype=torch.float32),
                       "exp_avg": torch.zeros_like(p),
                       "exp_avg_sq": torch.zeros_like(p)}
    return TrainState(masters, tx.state, 0), tx


def contrastive_loss(params: Params, batch: dict, cfg: bert_mod.BertConfig,
                     temperature: float = 0.05) -> torch.Tensor:
    """InfoNCE with in-batch negatives over (query, positive) pairs —
    the standard sentence-embedding fine-tune (bge/e5 recipe)."""
    q = bert_mod.embed_sentences(params, batch["q_ids"], batch["q_mask"], cfg,
                                 normalize=True)
    p = bert_mod.embed_sentences(params, batch["p_ids"], batch["p_mask"], cfg,
                                 normalize=True)
    logits = (q @ p.T) / temperature  # [B, B]
    labels = torch.arange(q.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels)


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every element of every tensor (`optax.global_norm`)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def contrastive_train_step(state: TrainState, batch: dict, cfg, tx
                           ) -> Tuple[TrainState, dict]:
    """One AdamW step on the contrastive loss → (state, {"loss",
    "grad_norm"}). The masters are updated in place; the metrics are
    device scalars (no host sync here), grad_norm taken before the update."""
    leaves = tree_leaves(state.params)
    tx.zero_grad(set_to_none=True)
    loss = contrastive_loss(state.params, batch, cfg)
    loss.backward()
    for p in leaves:
        if p.grad is None:  # JAX gives an unused leaf a zero gradient
            p.grad = torch.zeros_like(p)
    gnorm = global_norm([p.grad for p in leaves])
    tx.step()
    return (TrainState(state.params, tx.state, state.step + 1),
            {"loss": loss.detach(), "grad_norm": gnorm})
