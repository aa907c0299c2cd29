"""Pipeline parallelism (GPipe schedule) for decoder-LM training.

The port of `symbiont_tpu/parallel/pipeline.py` (`_block_dense`,
`stack_layers`, `shard_pp_params`, `lm_loss_pp`, `make_lm_train_step_pp`,
`make_pp_train_state`). The layers are stacked and their stack is split
over a `pipe` mesh axis (each entry holds a contiguous stage of depth
L/P); everything else is replicated. Microbatch activations flow from
stage to stage in GPipe order: at tick t stage p runs microbatch t - p,
and hands its output to stage p + 1 for the next tick as a copy between
devices (`.to`, JAX's `ppermute`). Autograd differentiates straight
through the copies, so the backward schedule falls out of the forward's,
as it falls out of `jax.grad` there.

Semantics are exact: the pipelined loss and step equal the plain
`trainer.lm_loss` and `lm_train_step` on the same batch, since each
microbatch's loss is accumulated as (Σ ce·w, Σ w) and normalised once.
The JAX schedule is one dense scan in which every stage computes every
tick, the ticks outside a stage's microbatches on stale data, masked out
of the loss; those ticks add exactly zero, so the port skips them, and
only stage 0 embeds and only the last stage scores.

A stage's attention (`_block_dense`): with `attn_impl="flash"` the
cache-free attention `trainer.lm_loss`'s forward takes (`gpt._attn` with
no cache): on CUDA the B1 forward, and under autograd B2/B3 where NH ==
NKV and B4's dense recompute for GQA; on the CPU their plain versions.
Otherwise JAX's dense causal math. The step crosses devices, so it runs
eagerly (`trainer.mesh_train_step`).

Over a mesh that spans processes each process places and runs only its
own stages, tick by tick as in one process, so the processes compute
their stages at once: every process makes the same calls with the whole
batch, and at the end of a tick the hand-offs to a stage of another
process cross in one `torch.distributed` exchange (`sharding.Chain`),
whose backward sends the gradients back. Each microbatch crosses once, so
the M backward chains are independent; the chain's token ties every
tick's exchange to the one before, which fixes their backward order (the
reverse of the ticks) in every process, so no process pairs one
microbatch's gradient with another's activations. Only stage 0's process
embeds and only the last stage's scores; the loss' sums are all-reduced
over the pipe axis' processes.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.parallel.mesh import Mesh
from symbiont_tpu_torch.parallel.sharding import (Chain, Line, NamedSharding, P, Sharded,
                                                  device_put, leaf_tensors, replicate)

Params = Any


def _block_dense(layer: Params, x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """One decoder block, causal attention over x's S tokens, no cache: a
    stage's training forward. Block scaffolding and QKV projection come
    from models/gpt (block_nocache / qkv_proj); only the attention's choice
    is this module's."""
    B, S, H = x.shape
    if gpt_mod._flash_prefill(cfg, S, None):
        rope = (gpt_mod._rope_angles(positions, cfg.head_dim, cfg.rope_theta)
                if cfg.arch == "llama" else None)
        return gpt_mod.block_nocache(layer, x, cfg, lambda h: gpt_mod._biased(
            gpt_mod._attn(layer, h, 0, None, cfg, rope, None, None), layer["o"]))
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim

    def attn(h):
        q, k, v = gpt_mod.qkv_proj(layer, h, positions, cfg)
        if nkv != nh:
            k = k.repeat_interleave(nh // nkv, dim=2)
            v = v.repeat_interleave(nh // nkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal, scores.float(), -1e9)
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H)
        return gpt_mod._proj(ctx, layer["o"])

    return gpt_mod.block_nocache(layer, x, cfg, attn)


# ------------------------------------------------------------------ params


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_layers(params: Params) -> Params:
    """The per-layer list of trees as one tree of stacked leaves with a
    leading layer axis: the shape the pipeline splits over `pipe`. The
    rest of the tree (embeddings, final norm, head) is passed through."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = _stack(params["layers"])
    return out


def layer_of(stacked_layers: Params, j: int) -> Params:
    """Layer j's tree of a stack of layers (`stack_layers(p)["layers"]`,
    or a stage's slice of it)."""
    return quant.tree_map(lambda a: a[j], stacked_layers)


def shard_pp_params(mesh: Mesh, stacked: Params, axis: str = "pipe") -> Params:
    """Place stacked params on the mesh: the layer stack split over the
    pipe axis (each entry holds its stage's depth), everything else
    replicated; over a mesh that spans processes, on this process's
    entries only."""
    n = mesh.shape[axis]
    L = next(quant.leaves(stacked["layers"])).shape[0]
    if L % n != 0:
        raise ValueError(f"num_layers {L} not divisible by pipe axis size {n}")
    placed = {k: replicate(mesh, v) for k, v in stacked.items() if k != "layers"}
    placed["layers"] = quant.tree_map(
        lambda a: device_put(a, NamedSharding(mesh, P(axis))), stacked["layers"])
    return placed


# ----------------------------------------------------------------- forward


def lm_loss_pp(params: Params, batch: dict, cfg, mesh: Mesh, axis: str = "pipe",
               num_microbatches: int = 4) -> torch.Tensor:
    """Masked next-token CE through the GPipe schedule. `params` is the
    stacked form (`stack_layers`), placed by `shard_pp_params` (or whole);
    batch["ids"/"mask"] [B, S] with B divisible by num_microbatches. Every
    stage reads its layers, and stage 0 and the last stage the shared
    leaves, from their masters (`Sharded.home`), copied to its device, so
    one backward sums every use's gradient into the masters. The stages
    are those of `axis`' line through entry 0 (`sharding.Line`); over a
    mesh that spans processes this process runs its own, and the loss is
    the whole (the same in every process) with the gradient of this
    process's share."""
    from symbiont_tpu_torch.train.trainer import _GlobalLoss, ce_terms

    line = Line(mesh, axis)
    n = len(line)
    ids, mask = batch["ids"], batch["mask"].float()
    B, S = ids.shape
    M = num_microbatches
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    dtype = torch_dtype(cfg.dtype)
    stack = list(quant.leaves(params["layers"]))
    if any(isinstance(x, Sharded) and x.spec[:1] != (axis,) for x in stack):
        raise ValueError(f"a placed layer stack must be split over {axis!r} "
                         "(shard_pp_params)")
    depth = stack[0].shape[0] // n  # a placed leaf's shape is the whole stack's
    entries = line.entries
    devs = {p: mesh.device_list[entries[p]] for p in line.local}

    def read(x, p: int, stage: bool):
        """Leaf x where stage p uses it: from its master, on p's device;
        a stage's own depth of a stacked leaf."""
        if isinstance(x, Sharded):
            return x.home(entries[p]).to(devs[p])
        return (x[p * depth:(p + 1) * depth] if stage else x).to(devs[p])

    def tree(t, p: int, stage: bool = False):
        return quant.cast_params(quant.tree_map(lambda x: read(x, p, stage), t), dtype)

    shared = {k: v for k, v in params.items() if k != "layers"}
    first = tree(shared, 0) if line.is_local(0) else None
    last = tree(shared, n - 1) if line.is_local(n - 1) else None
    stages = {p: tree(params["layers"], p, stage=True) for p in line.local}
    mB = B // M
    ids_m, mask_m = ids.reshape(M, mB, S), mask.reshape(M, mB, S)
    positions = {p: torch.arange(S, device=d).expand(mB, S) for p, d in devs.items()}
    lead = mesh.lead
    chain = (Chain(line.group, lead, torch.is_grad_enabled() and any(
                 t.requires_grad for x in quant.leaves(params) for t in leaf_tensors(x)))
             if line.group is not None else None)
    inbox = {}  # what stage p - 1 handed stage p at the last tick
    num = den = None
    for t in range(M + n - 1):
        done = {}  # stage → its output this tick, for stage p + 1
        for p in line.local:
            m = t - p
            if not 0 <= m < M:
                continue  # a tick JAX computes on stale data and masks: it adds zero
            x = (gpt_mod._embed(first, ids_m[m].to(devs[0]), positions[0], cfg, dtype)
                 if p == 0 else inbox.pop(p))
            for j in range(depth):
                x = _block_dense(layer_of(stages[p], j), x, positions[p], cfg)
            if p < n - 1:
                done[p] = x
                continue
            mb_ids, mb_mask = ids_m[m].to(devs[p]), mask_m[m].to(devs[p])
            ce, w = ce_terms(gpt_mod._logits(last, x, cfg)[:, :-1], mb_ids[:, 1:],
                             mb_mask[:, 1:] * mb_mask[:, :-1])
            num = ce.to(lead) if num is None else num + ce.to(lead)
            den = w.to(lead) if den is None else den + w.to(lead)
        inbox.update(_hand_off(done, t, M, line, chain, devs, (mB, S, cfg.hidden_size), dtype))
    if chain is None:
        return num / den.clamp_min(1.0)
    if num is None:  # no stage of this process scores: its share is the chain's
        num = den = torch.zeros((), device=lead)
    totals = line.group.all_reduce_(torch.stack([num.detach(), den]))
    whole = totals[1].clamp_min(1.0)
    return _GlobalLoss.apply(chain.close(num / whole), totals[0] / whole)


def _hand_off(done: dict, t: int, M: int, line: Line, chain, devs: dict, shape: tuple,
              dtype) -> dict:
    """The end of tick t: each stage p that ran a microbatch hands its
    output to stage p + 1 → {p + 1: its input at tick t + 1} for this
    process's stages. A copy where both stages are this process's; the
    rest cross in the tick's one exchange of the chain, made by every
    process with a stage on either side of such a hand-off."""
    out, sends, recvs, into = {}, [], [], []
    for p in range(len(line) - 1):
        if not 0 <= t - p < M:
            continue
        here, there = line.is_local(p), line.is_local(p + 1)
        if here and there:
            out[p + 1] = done[p].to(devs[p + 1])
        elif here:
            sends.append((done[p], line.owners[p + 1]))
        elif there:
            recvs.append((line.owners[p], (shape, dtype, devs[p + 1])))
            into.append(p + 1)
    if sends or recvs:
        out.update(zip(into, chain.exchange(sends, recvs)))
    return out


def make_lm_train_step_pp(mesh: Mesh, cfg, tx, axis: str = "pipe", num_microbatches: int = 4):
    """A pipeline-parallel LM train step bound to (mesh, axis) →
    `step(state, batch)` with `trainer.lm_train_step`'s contract: (state,
    {"loss", "grad_norm"}). The state's params are the stacked and placed
    form (`make_pp_train_state`), `tx` its AdamW over each block's master;
    the replicas are copied from their masters after each update."""
    from symbiont_tpu_torch.train import trainer

    def lm_loss_pp_step(params, batch, cfg):
        return lm_loss_pp(params, batch, cfg, mesh, axis, num_microbatches)

    return trainer.mesh_train_step(cfg, tx, lm_loss_pp_step, mesh=mesh)


def make_pp_train_state(mesh: Mesh, params: Params, learning_rate: float = 3e-4,
                        axis: str = "pipe") -> Tuple[Any, torch.optim.AdamW]:
    """A train state over the stacked and placed params → (state, tx):
    float32 copies of `params`, stacked (`stack_layers`) and placed
    (`shard_pp_params`), and the AdamW of `make_lm_train_state` (same
    hyperparameters, so the pipelined and plain steps stay in lockstep)
    over each block's master: each stage's home shard of the stacked
    leaves, the first entry's copy of the replicated ones. `params` is
    left as it is."""
    from symbiont_tpu_torch.train import trainer

    with torch.no_grad():
        placed = shard_pp_params(mesh, stack_layers(quant.tree_map(
            lambda t: t.detach().to(torch.float32).clone(), params)), axis=axis)
    tx = trainer.placed_adamw(placed, learning_rate)
    return trainer.TrainState(placed, tx.state, 0), tx
