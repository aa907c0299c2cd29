"""Ring attention: sequence-parallel exact attention over the mesh.

The port of `symbiont_tpu/parallel/ring_attention.py` (`ring_attention`,
`ring_attention_sharded`). The sequence is split over a mesh axis; each
entry keeps its query block and the K/V blocks travel round the ring, one
hop a step, while every entry folds the block it holds into a float32
streaming softmax (running max, denominator and accumulator, as flash
attention keeps them). Attention over a sequence of S costs O(S/n) memory
an entry.

The port has no `shard_map`: `ring_attention` takes the per-entry blocks
of q, k and v (one for each entry of the axis, on its device, in axis
order, as a `Sharded` holds them) and returns the per-entry output
blocks. The `ppermute` that hands a block on becomes a copy to the next
entry's device (`.to`) where that entry is this process's, which autograd
carries backward as it stands. Over a mesh that spans processes
(`mesh=`), a process holds only its entries' blocks (None for the rest),
and a hop to an entry of another process goes through `torch.distributed`
(`sharding.Chain.exchange`: K and V as one tensor, one exchange a step,
its backward the reverse exchange of the gradients). The per-block scores
are plain torch on every device, as they are plain XLA in the JAX package
(no Pallas kernel is involved there); running them through the flash
kernels on a global lse is ROADMAP's K-item for the ring.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from symbiont_tpu_torch.parallel.mesh import Mesh
from symbiont_tpu_torch.parallel.sharding import Line, NamedSharding, P, device_put


def ring_attention(q: Sequence[Optional[torch.Tensor]], k: Sequence[Optional[torch.Tensor]],
                   v: Sequence[Optional[torch.Tensor]], causal: bool = False,
                   mesh: Optional[Mesh] = None, axis: str = "data") -> list:
    """Exact attention over the whole sequence of the blocks `q[i]`
    [B, S_loc, NH, D], `k[i]`/`v[i]` [B, S_loc, KVH, D] (entry i's, on its
    device; entry i holds global positions [i·S_loc, (i+1)·S_loc)) →
    each entry's output block [B, S_loc, NH, D] in q's dtype, on its
    device. Over `mesh` (the blocks are those of `axis`' line through entry
    0, `sharding.Line`) another process's blocks are None, and so are
    their outputs here; every process of the line makes the call.

    n steps: at step s entry i holds the K/V block of entry (i - s) mod n,
    scores it against its queries, and hands it on to entry i + 1.
    GQA-aware: K/V may carry fewer heads than Q (KVH | NH). The compact KVH
    blocks are what rotates, K and V stacked as one; they are expanded to
    NH only for the local scores. A fully masked block (causal, a later
    block) adds nothing: its scores are -inf, and the guards keep the
    running max and the correction finite. The running max is a constant
    of the softmax (the output does not depend on it), so no gradient is
    taken through it."""
    n = len(q)
    if not (len(k) == len(v) == n):
        raise ValueError(f"{n} query blocks but {len(k)} key and {len(v)} value blocks")
    line = Line(mesh, axis, n)
    if len(line) != n:
        raise ValueError(f"{n} blocks for the {len(line)} entries of the {axis} line")
    local = line.local
    if any(q[i] is None or k[i] is None or v[i] is None for i in local):
        raise ValueError(f"a block of this process's entries {local} is missing")
    B, S, NH, D = q[local[0]].shape
    KVH = k[local[0]].shape[2]
    if NH % KVH != 0:
        raise ValueError(f"query heads {NH} not divisible by KV heads {KVH}")
    rep = NH // KVH
    scale = 1.0 / math.sqrt(D)
    devs = {i: q[i].device for i in local}
    chain = line.chain([q[i] for i in local] + [k[i] for i in local] + [v[i] for i in local])

    def expand(blk):  # [B, S, KVH, D] → [B, S, NH, D] (local, after the hop)
        return blk.repeat_interleave(rep, dim=2) if rep > 1 else blk

    q32 = {i: q[i].float() for i in local}
    pos = {i: i * S + torch.arange(S, device=devs[i]) for i in local}
    m = {i: torch.full((B, NH, S), -math.inf, device=devs[i]) for i in local}
    l = {i: torch.zeros((B, NH, S), device=devs[i]) for i in local}
    acc = {i: torch.zeros((B, NH, S, D), device=devs[i]) for i in local}
    kv = {i: torch.stack([k[i], v[i]]) for i in local}  # what travels: [2, B, S, KVH, D]
    for s in range(n):
        for i in local:
            src = (i - s) % n
            scores = torch.einsum("bqhd,bkhd->bhqk", q32[i], expand(kv[i][0]).float()) * scale
            if causal:
                hidden = pos[i][:, None] < (src * S + torch.arange(S, device=devs[i]))[None, :]
                scores = scores.masked_fill(hidden, -math.inf)
            new_m = torch.maximum(m[i], scores.detach().amax(dim=-1))
            correction = torch.where(torch.isneginf(m[i]), 0.0, torch.exp(m[i] - new_m))
            probs = torch.exp(scores - torch.where(torch.isneginf(new_m), 0.0, new_m)[..., None])
            probs = torch.where(torch.isneginf(scores), 0.0, probs)
            l[i] = l[i] * correction + probs.sum(dim=-1)
            acc[i] = acc[i] * correction[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", probs, expand(kv[i][1]).float())
            m[i] = new_m
        if s < n - 1:  # the hop: entry i - 1's block goes on to entry i
            kv = _hop(kv, line, chain, devs)
    outs = [None] * n
    for i in local:
        outs[i] = (acc[i] / l[i].clamp_min(1e-30)[..., None]).transpose(1, 2).to(q[i].dtype)
    if chain is not None:
        outs[local[0]] = chain.close(outs[local[0]])
    return outs


def _hop(kv: dict, line: Line, chain, devs: dict) -> dict:
    """One step of the ring: each local entry i takes entry i - 1's block,
    a copy where that entry is this process's, else received in the
    step's one exchange (which also sends this process's blocks whose
    next entry is another process's)."""
    n = len(line)
    out, sends, recvs, into = {}, [], [], []
    for i in range(n):
        prev = (i - 1) % n
        if line.is_local(i) and line.is_local(prev):
            out[i] = kv[prev].to(devs[i])
        elif line.is_local(prev):
            sends.append((kv[prev], line.owners[i]))
        elif line.is_local(i):
            like = kv[line.local[0]]
            recvs.append((line.owners[prev], (like.shape, like.dtype, devs[i])))
            into.append(i)
    if sends or recvs:
        out.update(zip(into, chain.exchange(sends, recvs)))
    return out


def split_sequence(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """`x` [B, S, ...] split on its sequence dim over `axis` (a `Sharded`
    with spec P(None, axis)) → the blocks of the entries of the axis' line
    through entry 0 in order, each on its device (None for another
    process's)."""
    placed = device_put(x, NamedSharding(mesh, P(None, axis)))
    return [placed.shards[mesh.flat_index(**{axis: i})] for i in range(mesh.shape[axis])]


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                           axis_name: str = "data", causal: bool = False) -> torch.Tensor:
    """Split q, k, v [B, S, heads, D] on the sequence dim over `axis_name`
    and run the ring → the whole [B, S, NH, D] result on the mesh's lead
    entry; over a mesh that spans processes a `Sharded` over the sequence
    axis holding this process's blocks (`Line.join`; `.gather()` is the
    whole)."""
    outs = ring_attention(*(split_sequence(t, mesh, axis_name) for t in (q, k, v)),
                          causal=causal, mesh=mesh, axis=axis_name)
    return Line(mesh, axis_name).join(outs, 1, q.shape)
