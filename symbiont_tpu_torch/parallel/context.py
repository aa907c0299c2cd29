"""Context parallelism: the sequence-split decoder training forward.

The port of `symbiont_tpu/parallel/context.py` (`_block_sp`,
`gpt_forward_sp`, `lm_loss_sp`, `make_lm_train_step_sp`). Long-context LM
training is first-class: the batch's sequence dim is split over a mesh
axis, every token-mixing op but attention is local to an entry, and
attention is exact over the whole sequence through the ring
(`ring_attention.py`: K/V blocks travel round the entries while a
streaming softmax accumulates) or through Ulysses (`ulysses.py`: two
all-to-alls round the flash kernels). Activation memory an entry is
O(S/n); attention is exact, not windowed.

The training-side complement of the KV-cache forward of `models/gpt.py`:
the same params tree and the same block math (`gpt.block_nocache`,
`gpt.qkv_proj`), no cache; causality comes from the global positions.

The port has no `shard_map`: a process runs each of its entries' part in
turn (the mesh of `parallel/mesh.py`). The params stay where the train
state holds them (its masters), and each entry reads them through a copy
to its device, as the dp×tp step reads each block from its master, so one
backward sums every entry's gradient into the masters. The step crosses
devices, so it runs eagerly (`trainer.mesh_train_step`).

Over a mesh that spans processes every process makes the same calls with
the whole batch and computes only its entries' blocks; the attention's
hops and trades cross between the processes (`ring_attention`,
`ulysses`). The ids are whole everywhere, so the loss' one-token halo
needs no traffic; the loss' sums are all-reduced over the axis' processes,
and each process's masters (a replica of the whole tree, as JAX's `P()`
params are) take its share of the gradient, summed over the processes by
`trainer.mesh_train_step` before the norm and the update.
"""

from __future__ import annotations

from typing import Any

import torch

from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.parallel.mesh import Mesh
from symbiont_tpu_torch.parallel.ring_attention import ring_attention
from symbiont_tpu_torch.parallel.sharding import Line, mesh_of
from symbiont_tpu_torch.parallel.ulysses import ulysses_attention

Params = Any
ATTN_IMPLS = ("ring", "ulysses")


def _block_sp(layers, xs, positions, cfg, attn_impl: str, line: Line) -> list:
    """One decoder block with sequence-parallel attention: xs[i] [B, S_loc,
    H] is the block of the line's local position `line.local[i]`,
    positions[i] [B, S_loc] its global positions, layers[i] the layer's
    tree on its device. Block scaffolding and the QKV projection come from
    models/gpt (block_nocache / qkv_proj): only the attention schedule is
    this module's."""
    nh, nkv = cfg.num_heads, cfg.kv_heads
    n, local = len(line), line.local

    def spread(blocks):  # this process's blocks → one a position, None for another's
        out = [None] * n
        for i, b in zip(local, blocks):
            out[i] = b
        return out

    def attn(hs):
        q, k, v = zip(*(gpt_mod.qkv_proj(layer, h, pos, cfg)
                        for layer, h, pos in zip(layers, hs, positions)))
        if attn_impl == "ulysses":
            # Ulysses re-splits the heads over the axis, so K/V must be at
            # the query heads' count first (the all-to-all splits the head dim)
            if nkv != nh:
                k = [t.repeat_interleave(nh // nkv, dim=2) for t in k]
                v = [t.repeat_interleave(nh // nkv, dim=2) for t in v]
            fn = ulysses_attention
        else:
            # GQA: K/V stay at nkv heads; the ring rotates the compact
            # blocks and expands them to nh only for the local scores
            fn = ring_attention
        ctx = fn(spread(q), spread(k), spread(v), causal=True, mesh=line.mesh, axis=line.axis)
        return [gpt_mod._proj(ctx[i].reshape(h.shape), layer["o"])
                for i, h, layer in zip(local, hs, layers)]

    return gpt_mod.block_nocache(layers, xs, cfg, attn)


def _forward_blocks(params: Params, input_ids: torch.Tensor, mesh: Mesh, cfg, axis: str,
                    attn_impl: str) -> tuple:
    """Each local entry's float32 logits [B, S/n, V], on its device →
    (the line, the logits of its positions, None for another process's)."""
    line = Line(mesh, axis)
    n = len(line)
    B, S = input_ids.shape
    if S % n != 0:
        raise ValueError(f"sequence length {S} not divisible by mesh axis {axis!r} size {n}")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} is not one of {ATTN_IMPLS}")
    if mesh_of(params) is not None:
        raise ValueError("the sequence-parallel forward takes a plain params tree (every "
                         "entry reads it through a copy), not one placed on a mesh")
    dtype = torch_dtype(cfg.dtype)
    devs = [mesh.device_list[line.entries[i]] for i in line.local]
    S_loc = S // n
    trees = [quant.cast_params(quant.tree_map(lambda x: x.to(d), params), dtype) for d in devs]
    positions = [(i * S_loc + torch.arange(S_loc, device=d)).expand(B, S_loc)
                 for i, d in zip(line.local, devs)]
    xs = [gpt_mod._embed(t, input_ids[:, i * S_loc:(i + 1) * S_loc].to(d), pos, cfg, dtype)
          for i, t, d, pos in zip(line.local, trees, devs, positions)]
    for j in range(len(params["layers"])):
        xs = _block_sp([t["layers"][j] for t in trees], xs, positions, cfg, attn_impl, line)
    blocks = [None] * n
    for i, t, x in zip(line.local, trees, xs):
        blocks[i] = gpt_mod._logits(t, x, cfg)
    return line, blocks


def gpt_forward_sp(params: Params, input_ids: torch.Tensor, mesh: Mesh, cfg,
                   axis: str = "data", attn_impl: str = "ring"):
    """Sequence-parallel training forward → float32 logits [B, S, V] on the
    mesh's lead entry; over a mesh that spans processes a `Sharded` over
    the sequence axis holding this process's blocks (`Line.join`;
    `.gather()` is the whole). input_ids [B, S], S divisible by the axis
    size; attn_impl "ring" or "ulysses". The only traffic between entries
    is the attention's (and the params' copies). Equal to the KV-cache
    forward (models/gpt.py) in the tests."""
    line, blocks = _forward_blocks(params, input_ids, mesh, cfg, axis, attn_impl)
    B, S = input_ids.shape
    return line.join(blocks, 1, torch.Size((B, S, blocks[line.local[0]].shape[-1])))


def lm_loss_sp(params: Params, batch: dict, cfg, mesh: Mesh, axis: str = "data",
               attn_impl: str = "ring") -> torch.Tensor:
    """`trainer.lm_loss` over a sequence-split forward. Each entry scores
    its own positions; the shifted target of its last position is the
    next entry's first token (a one-token halo: the ids are whole in every
    process), so the sum is exact. The sums (Σ ce·w, Σ w) meet on the
    lead and are normalised once; over a mesh that spans processes they
    are all-reduced over the axis' processes first, and the loss returned
    is the whole (the same in every process) with the gradient of this
    process's share (`trainer._GlobalLoss`)."""
    from symbiont_tpu_torch.train.trainer import _GlobalLoss, ce_terms

    ids = batch["ids"]
    mask = batch["mask"].float()
    line, blocks = _forward_blocks(params, ids, mesh, cfg, axis, attn_impl)
    S, lead = ids.shape[1], mesh.lead
    S_loc = S // len(line)
    num = den = None
    for i in line.local:
        logits = blocks[i]
        lo, hi = i * S_loc, min((i + 1) * S_loc, S - 1)  # positions with a next token
        dev = logits.device
        n, w = ce_terms(logits[:, :hi - lo], ids[:, lo + 1:hi + 1].to(dev),
                        (mask[:, lo + 1:hi + 1] * mask[:, lo:hi]).to(dev))
        num = n.to(lead) if num is None else num + n.to(lead)
        den = w.to(lead) if den is None else den + w.to(lead)
    if line.group is None:
        return num / den.clamp_min(1.0)
    totals = line.group.all_reduce_(torch.stack([num.detach(), den]))
    whole = totals[1].clamp_min(1.0)
    return _GlobalLoss.apply(num / whole, totals[0] / whole)


def make_lm_train_step_sp(mesh: Mesh, cfg, tx, axis: str = "data", attn_impl: str = "ring"):
    """A sequence-parallel LM train step bound to (mesh, axis) →
    `step(state, batch)` with `trainer.lm_train_step`'s contract: (state,
    {"loss", "grad_norm"}), on a state of `make_lm_train_state` and its
    AdamW `tx`. Activations are split over the sequence, so contexts far
    beyond one device's memory train exactly."""
    from symbiont_tpu_torch.train import trainer

    def lm_loss_sp_step(params, batch, cfg):
        return lm_loss_sp(params, batch, cfg, mesh, axis, attn_impl)

    return trainer.mesh_train_step(cfg, tx, lm_loss_sp_step, mesh=mesh)
