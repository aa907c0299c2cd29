"""The train steps: the encoder fine-tune (a contrastive step over
(query, passage) pairs) and the LM fine-tune (next-token cross-entropy).

The port of `symbiont_tpu/train/trainer.py`, with its names (`TrainState`,
`make_embedder_train_state`, `contrastive_loss`, `contrastive_train_step`,
`make_lm_train_state`, `lm_loss`, `lm_train_step`). The JAX package's
pure-function step becomes PyTorch's idiom: float32 master leaves with
`requires_grad`, one backward, and `torch.optim.AdamW` updating them in
place. AdamW with betas (0.9,
0.999), eps 1e-8 and weight decay 0.01 on every leaf is the update of
`optax.adamw(lr, weight_decay=0.01)`: decoupled decay from the old value
plus the bias-corrected moment step, the same formula term by term.

`TrainState.opt_state` is the optimizer's own state (`tx.state`: per leaf
`step`, `exp_avg` = optax's `mu`, `exp_avg_sq` = `nu`), filled at creation
so a checkpoint can be restored into it before the first step; the
gradients are allocated there too, and every step zeroes them in place.

Each step is an executable, as JAX jits `contrastive_train_step` and
`lm_train_step` with the state donated: one per batch shape (pairs, q
bucket, p bucket; or rows, sequence length) and config (`graphs.py`),
kept for its optimizer (`step_executables`). On CUDA it is a graph that
holds the forward (B1), the backward through `_FlashAttention` (B2 and B3
where NH == NKV; GQA takes the dense float32 recompute, B4, as in JAX)
and the AdamW update, bound to the masters, moments, step counts and
gradients in place, with the loss and the grad norm as its outputs; the
AdamW there is `capturable=True` (its step counts on the device, bias
corrections as device ops), eager or replayed alike. Its step counts are float64, so the bias corrections 1 - β^t are
taken in float64 as the CPU's AdamW takes them on the host: in float32,
1 - 0.999 is off by 1.3e-5 of itself. On the CPU the same executable
runs the step eagerly, with the step counts on the host (a capturable
AdamW refuses CPU tensors). A restore writes the state in place
(`train/checkpoint.load_train_state`), so a graph survives it.

With `cfg.attn_impl="flash"` the attention runs the CUDA flash-attention
forward and the fused backward kernels (dK/dV/dbias, dQ) on CUDA tensors,
their plain versions on CPU ones (`ops/flash_attention.py`): the encoder's
with its padding bias, the LM's causal over the packed rows. The step
runs where the params and batch live: the card unless the caller hands it
CPU tensors, as the tests do.

On a mesh (A15 stage 1, JAX's `shard_lm_train_state`): the masters are
placed on the megatron TP rules and replicated over 'data'; `lm_loss`
runs each data row's share of the batch through `gpt.forward` on that
row's tensor entries (B1 forward, B2/B3 backward on each shard's heads),
reading every block from its master, so one backward sums each use's
gradient into it through the copies between devices, and the AdamW then
updates the masters and copies them to the replicas. Such a step crosses
devices, so its executable runs eagerly (`graphs.Executable(eager=True)`).
Over a mesh that spans processes (A15 multi-host,
`parallel/mesh.init_distributed`) each process runs the same two calls
(`shard_lm_train_state`, then `lm_train_step`) on the entries it holds:
`lm_loss` takes its local data rows; each row's Σce·w and Σw count once,
at the first process of the row's tensor line (the others seed a zero
that carries their part of the backward's collectives), and the sums over
the mesh's processes make every process's loss the global one, its
gradient this process's share. After the backward each replicated
master's gradient is summed over the processes that hold its block (one
flat all-reduce a group, `_reduce_grads`), the grad norm counts each block
once across processes, and each process's AdamW updates its own masters
identically, as DDP keeps replicas.
The sequence- and pipeline-parallel steps (A15 stage 2,
`parallel/context.py`, `parallel/pipeline.py`) are `mesh_train_step`s
over their losses, eager too; `placed_adamw` is the AdamW over a placed
tree's masters that `shard_lm_train_state` and the pipeline's state share.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from symbiont_tpu_torch.graphs import Executable, GraphPool
from symbiont_tpu_torch.models import bert as bert_mod
from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.parallel.mesh import axis_size
from symbiont_tpu_torch.parallel.sharding import (
    Sharded,
    gpt_param_sharding,
    mesh_of,
    shard_params,
)

Params = Any

# each optimizer's step executables, by (q shape, p shape, cfg), and the
# pool their graphs share; an entry goes with its optimizer
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

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


def _make_train_state(params: Params, learning_rate: float
                      ) -> Tuple[TrainState, torch.optim.AdamW]:
    """float32 master copies of `params` (on their device) and the AdamW
    over them, its moments zero, as `optax.adamw(...).init` gives them, and
    zero gradients. On CUDA the AdamW is capturable, its step counts
    float64 on the device. The masters are always copies: a float32 leaf
    is cloned too, so they never share storage with `params`."""
    masters = bert_mod.tree_map(
        lambda t: t.detach().to(torch.float32).clone().requires_grad_(), params)
    leaves = tree_leaves(masters)
    on_card = bool(leaves) and leaves[0].is_cuda
    tx = torch.optim.AdamW(leaves, lr=learning_rate, betas=ADAM_BETAS,
                           eps=ADAM_EPS, weight_decay=WEIGHT_DECAY, capturable=on_card)
    for p in leaves:
        # the layout AdamW builds lazily at its first step
        tx.state[p] = {"step": (torch.tensor(0.0, dtype=torch.float64, device=p.device)
                                if on_card else torch.tensor(0.0, dtype=torch.float32)),
                       "exp_avg": torch.zeros_like(p),
                       "exp_avg_sq": torch.zeros_like(p)}
        p.grad = torch.zeros_like(p)
    return TrainState(masters, tx.state, 0), tx


def make_embedder_train_state(params: Params, learning_rate: float = 1e-4
                              ) -> Tuple[TrainState, torch.optim.AdamW]:
    """The encoder's train state (`_make_train_state`), lr 1e-4."""
    return _make_train_state(params, learning_rate)


def make_lm_train_state(params: Params, learning_rate: float = 3e-4
                        ) -> Tuple[TrainState, torch.optim.AdamW]:
    """The LM's train state (`_make_train_state`), lr 3e-4, the same AdamW
    as the encoder's."""
    return _make_train_state(params, learning_rate)


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


def lm_loss(params: Params, batch: dict, cfg: gpt_mod.GPTConfig) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token batches, weighted by the
    mask: a target counts where it and the token before it are real. The
    forward keeps no cache (`gpt.forward(cache=None)`), so K/V are never
    quantized on it (quantize-on-append's round() has no gradient); the
    config's `kv_quant` is set to "none" all the same, as JAX's `lm_loss`
    sets it, so no part of the training forward reads an int8 setting."""
    ids = batch["ids"]
    mask = batch["mask"]
    mask = mask if isinstance(mask, Sharded) else mask.float()
    if cfg.kv_quant != "none":
        cfg = dataclasses.replace(cfg, kv_quant="none")
    mesh = mesh_of(params)
    if mesh is None:
        num, den = _lm_loss_terms(gpt_mod.forward, params, ids, mask, cfg)
        return num / den.clamp_min(1.0)
    # a mesh: data row d runs the TP forward on its share of the rows, from
    # the masters (`home`), and the sums meet on the lead
    lead = mesh.lead
    num = den = None
    for d in _local_rows(mesh):
        dev = mesh.device_list[gpt_mod._tensor_entries(mesh, d)[0]]
        fwd = functools.partial(gpt_mod.forward, row=d, home=True)
        n, w = _lm_loss_terms(fwd, params, _data_rows(batch["ids"], mesh, d).to(dev),
                              _data_rows(batch["mask"], mesh, d).to(dev).float(), cfg)
        if not _leads_row(mesh, d):  # counted at the row's first process
            n, w = n * 0.0, w * 0.0
        num = n.to(lead) if num is None else num + n.to(lead)
        den = w.to(lead) if den is None else den + w.to(lead)
    if not mesh.spans_processes:
        return num / den.clamp_min(1.0)
    totals = torch.stack([num.detach(), den])
    mesh.group(mesh.axis_names, 0).all_reduce_(totals)
    whole = totals[1].clamp_min(1.0)
    return _GlobalLoss.apply(num / whole, totals[0] / whole)


class _GlobalLoss(torch.autograd.Function):
    """The value of the whole mesh's loss (`total`, the same on every
    process) with the gradient of this process's share (`share`)."""

    @staticmethod
    def forward(ctx, share, total):
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local_rows(mesh) -> list:
    """The data rows of the mesh with an entry in this process."""
    return sorted({mesh.coords(i)["data"] for i in mesh.local_entries})


def _leads_row(mesh, d: int) -> bool:
    """Whether this process is the first of data row d's tensor line."""
    return mesh.process == min(mesh.process_index(mesh.flat_index(data=d, tensor=t))
                               for t in range(axis_size(mesh, "tensor")))


def _lm_loss_terms(forward, params, ids, mask, cfg):
    """(Σ ce·w, Σ w) of `lm_loss` over one block of rows."""
    B, S = ids.shape
    positions = torch.arange(S, device=ids.device).expand(B, S)
    logits, _ = forward(params, ids, None, positions, cfg)
    return ce_terms(logits.to(ids.device)[:, :-1], ids[:, 1:], mask[:, 1:] * mask[:, :-1])


def ce_terms(logits: torch.Tensor, targets: torch.Tensor, w: torch.Tensor):
    """(Σ ce·w, Σ w): the cross-entropy of float32 logits [B, T, V]
    against the target ids [B, T], weighted by w [B, T]; `lm_loss` is the
    first over the second, summed over every block of the batch."""
    B, T = targets.shape
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(),
                         reduction="none").view(B, T)
    return (ce * w).sum(), w.sum()


def _data_rows(x, mesh, d: int) -> torch.Tensor:
    """Data row d's share of a batch tensor: its shard at the row's first
    local entry when the batch was placed on the mesh (`batch_sharding`),
    else its contiguous block of rows."""
    if isinstance(x, Sharded):
        return x.shards[next(i for i in mesh.local_entries if mesh.coords(i)["data"] == d)]
    nd = axis_size(mesh, "data")
    if x.shape[0] % nd:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over data={nd}")
    per = x.shape[0] // nd
    return x[d * per:(d + 1) * per]


# the batch tensors each loss reads, in the order its executable takes them
CONTRASTIVE_KEYS = ("q_ids", "q_mask", "p_ids", "p_mask")
LM_KEYS = ("ids", "mask")


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every element of every tensor (`optax.global_norm`),
    on the first tensor's device."""
    tensors = list(tensors)
    dev = tensors[0].device
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()).to(dev) for t in tensors]))


def masters(params: Params) -> list:
    """The tensors an optimizer updates: the leaves, or for a tree placed
    on a mesh each local block's home shard (`Sharded.home`), leaf by
    leaf."""
    out = []
    for leaf in tree_leaves(params):
        if isinstance(leaf, Sharded):
            out += leaf.homes()
        else:
            out.append(leaf)
    return out


def _sync_replicas(params: Params) -> None:
    """Every local shard of a mesh-placed tree that is not its block's
    home copied from it, after an update of the homes."""
    for leaf in tree_leaves(params):
        if isinstance(leaf, Sharded):
            for i in leaf.mesh.local_entries:
                if leaf.home_index(i) != i:
                    leaf.shards[i].copy_(leaf.home(i))


def _home_entries(params: Params):
    """(leaf, flat entry) of every local master of a mesh-placed tree,
    leaf by leaf, each leaf's blocks in block order (the same order on
    every process that holds them)."""
    for leaf in tree_leaves(params):
        yield from ((leaf, i) for i in sorted(
            (i for i in leaf.mesh.local_entries if leaf.home_index(i) == i), key=leaf.block))


def _reduce_grads(params: Params) -> None:
    """On a mesh that spans processes: each master's gradient summed over
    the processes that hold its block (`Sharded.holders`), one flat
    all-reduce a group, the groups in one order on every process."""
    buckets: dict = {}
    for leaf, i in _home_entries(params):
        group = leaf.holders(i)
        if group is not None:
            buckets.setdefault(group.ranks, (group, []))[1].append(leaf.shards[i].grad)
    for ranks in sorted(buckets):
        group, grads = buckets[ranks]
        flat = group.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def _spanning_norm(params: Params) -> torch.Tensor:
    """`global_norm` of a mesh-placed tree's gradients across processes:
    each block counted once, at the first process that holds it, the
    squares summed over the mesh's processes."""
    mesh = mesh_of(params)
    sq = torch.zeros((), device=mesh.lead)
    for leaf, i in _home_entries(params):
        group = leaf.holders(i)
        if group is None or group.ranks[0] == mesh.process:
            sq = sq + torch.linalg.vector_norm(leaf.shards[i].grad.float()).to(mesh.lead) ** 2
    return mesh.group(mesh.axis_names, 0).all_reduce_(sq).sqrt()


def _step_fn(params: Params, tx, cfg, loss_fn=contrastive_loss, keys=CONTRASTIVE_KEYS):
    """One AdamW step over `params` on `loss_fn` as a function of the
    batch's tensors `keys`, in that order → (loss, grad_norm): the
    gradients zeroed in place (a leaf that gets none keeps zeros, as JAX
    gives an unused leaf), one backward into them, the norm taken before
    the update."""
    leaves = masters(params)
    mesh = mesh_of(params)
    sharded = mesh is not None
    spanning = sharded and mesh.spans_processes
    tx_ref = weakref.ref(tx)  # the executable must not keep the optimizer alive

    def step(*tensors):
        grads = [p.grad for p in leaves]
        torch._foreach_zero_(grads)
        loss = loss_fn(params, dict(zip(keys, tensors, strict=True)), cfg)
        loss.backward()
        if spanning:
            _reduce_grads(params)
            gnorm = _spanning_norm(params)
        else:
            gnorm = global_norm(grads)
        tx_ref().step()
        if sharded:
            with torch.no_grad():
                _sync_replicas(params)
        return loss.detach(), gnorm

    return step


def step_executables(tx) -> dict:
    """The step executables built for the optimizer `tx`, by the shapes of
    the batch's ids (q and p, or the LM's one) and cfg."""
    return dict(_STEPS[tx]["exes"]) if tx in _STEPS else {}


def _step_executable(state: TrainState, batch: dict, cfg, tx, loss_fn=contrastive_loss,
                     keys=CONTRASTIVE_KEYS, own=None, eager: bool = False) -> Executable:
    """The step's executable for this batch shape, kept for `tx` (or in
    `own`, a step's own {"exes", "pool"}): one per (shapes of the batch's
    ids, cfg), built on the state's masters. On CUDA its capture's
    warm-up runs a whole step, and the masters, moments and step counts
    come back to what they held before it (`carry`). `eager`: the step
    runs eagerly, as one over a mesh-placed state always does (it crosses
    devices)."""
    leaves = masters(state.params)
    device = leaves[0].device
    eager = eager or mesh_of(state.params) is not None
    if own is None:
        own = _STEPS.get(tx)
    if own is None:
        own = _STEPS[tx] = {"exes": {},
                            "pool": GraphPool() if device.type == "cuda" and not eager
                            else None}
    key = tuple(tuple(batch[k].shape) for k in keys if k.endswith("ids")) + (cfg,)
    exe = own["exes"].get(key)
    if exe is None or exe.params is not state.params:
        carry = None
        if device.type == "cuda" and not eager:
            moments = [tx.state[p] for p in leaves]
            carry = [t.detach() for t in leaves] + [m[k] for m in moments
                                                    for k in ("step", "exp_avg", "exp_avg_sq")]
        shapes = ",".join("x".join(map(str, batch[k].shape)) for k in keys if k.endswith("ids"))
        exe = own["exes"][key] = Executable(
            _step_fn(state.params, tx, cfg, loss_fn, keys), device, pool=own["pool"],
            carry=carry, signature=f"train.{getattr(loss_fn, '__name__', 'loss')}_step[{shapes}]",
            eager=eager)
        exe.params = state.params
    return exe


def contrastive_train_step(state: TrainState, batch: dict, cfg, tx
                           ) -> Tuple[TrainState, dict]:
    """One AdamW step on the contrastive loss → (state, {"loss",
    "grad_norm"}), through the step's executable (a replayed graph on
    CUDA). The masters are updated in place; the metrics are device
    scalars (no host sync here), grad_norm taken before the update. On
    CUDA a batch shape's first step captures: the caller must not then
    hold an autograd graph over the masters (a loss of its own), whose
    gradient accumulators would tie the capture's backward to another
    stream, and the capture raises."""
    exe = _step_executable(state, batch, cfg, tx)
    loss, gnorm = exe(*(batch[k] for k in CONTRASTIVE_KEYS))
    return (TrainState(state.params, tx.state, state.step + 1),
            {"loss": loss, "grad_norm": gnorm})


def lm_train_step(state: TrainState, batch: dict, cfg: gpt_mod.GPTConfig, tx
                  ) -> Tuple[TrainState, dict]:
    """One AdamW step on `lm_loss` over `batch` ({"ids", "mask"}, [B, S])
    → (state, {"loss", "grad_norm"}), as `contrastive_train_step`: one
    executable per (B, S) and cfg, a replayed graph on CUDA, the masters
    updated in place, device scalars out. The caller holds no autograd
    graph over the masters when a shape's first step captures."""
    exe = _step_executable(state, batch, cfg, tx, lm_loss, LM_KEYS)
    loss, gnorm = exe(*(batch[k] for k in LM_KEYS))
    return (TrainState(state.params, tx.state, state.step + 1),
            {"loss": loss, "grad_norm": gnorm})


def mesh_train_step(cfg: gpt_mod.GPTConfig, tx, loss_fn, keys=LM_KEYS):
    """A train step on `loss_fn(params, batch, cfg)`, a loss that runs over
    mesh entries (the sequence- and pipeline-parallel LM losses of
    `parallel/context.py` and `parallel/pipeline.py`) → `step(state,
    batch)` with `lm_train_step`'s contract: (state, {"loss",
    "grad_norm"}), the masters updated in place by `tx`. Such a step
    crosses devices, so its executables (one per batch shape, held by the
    step) run eagerly, as the dp×tp step's do."""
    own = {"exes": {}, "pool": None}

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        exe = _step_executable(state, batch, cfg, tx, loss_fn, keys, own=own, eager=True)
        loss, gnorm = exe(*(batch[k] for k in keys))
        return (TrainState(state.params, tx.state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step


def placed_adamw(params: Params, lr: float, betas=ADAM_BETAS, eps: float = ADAM_EPS,
                 weight_decay: float = WEIGHT_DECAY, moments=None) -> torch.optim.AdamW:
    """An AdamW over the masters of a mesh-placed tree (`masters`: each
    block's home shard), each made a leaf that takes gradients. `moments`,
    where given, is one {"step", "exp_avg", "exp_avg_sq"} a master, in
    `masters` order; else the moments start at zero at step 0, the layout
    `_make_train_state` builds. Capturable on CUDA, step counts float64
    there."""
    homes = masters(params)
    on_card = homes[0].is_cuda
    tx = torch.optim.AdamW(homes, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                           capturable=on_card)
    if moments is None:
        moments = [{"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)} for p in homes]
    for p, st in zip(homes, moments, strict=True):
        p.requires_grad_()
        step = st["step"].detach()
        tx.state[p] = {"step": (step.to(torch.float64).to(p.device).clone() if on_card
                                else step.float().cpu().clone()),
                       "exp_avg": st["exp_avg"], "exp_avg_sq": st["exp_avg_sq"]}
        p.grad = torch.zeros_like(p)
    return tx


def shard_lm_train_state(mesh, state: TrainState, tx, arch: str = "gpt2"
                         ) -> Tuple[TrainState, torch.optim.AdamW]:
    """Place an LM train state on the mesh → (state, tx): the masters on
    the megatron TP rules (`parallel/sharding.gpt_param_sharding`),
    replicated over 'data'; the optimizer's moments mirror them block for
    block and its step counts are copied. Each block's master is the shard
    at the first entry that holds it (`Sharded.home`), and the returned
    AdamW (the hyperparameters of `tx`) updates exactly those; every other
    shard is a replica copied from its master after each step. The batch
    goes on the 'data' axis (the caller's `batch_sharding`, or a whole
    batch `lm_train_step` splits into contiguous rows). `state` and `tx`
    are left as they are: the placed masters are copies."""
    spec = gpt_param_sharding(mesh, state.params, arch=arch)

    def placed(pick):
        with torch.no_grad():
            return shard_params(mesh, bert_mod.tree_map(
                lambda p: pick(p).detach().clone(), state.params), spec)

    params = placed(lambda p: p)
    mu = placed(lambda p: tx.state[p]["exp_avg"])
    nu = placed(lambda p: tx.state[p]["exp_avg_sq"])
    step0 = tx.state[tree_leaves(state.params)[0]]["step"]
    group = tx.param_groups[0]
    tx2 = placed_adamw(params, group["lr"], group["betas"], group["eps"], group["weight_decay"],
                       [{"step": step0, "exp_avg": m, "exp_avg_sq": v}
                        for m, v in zip(masters(mu), masters(nu), strict=True)])
    return TrainState(params, tx2.state, state.step), tx2
