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
entry's device (`.to`), which autograd carries backward as it stands. The
per-block scores are plain torch on every device, as they are plain XLA in
the JAX package (no Pallas kernel is involved there); running them through
the flash kernels on a global lse is ROADMAP's K-item for the ring.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from symbiont_tpu_torch.parallel.mesh import Mesh, refuse_spanning
from symbiont_tpu_torch.parallel.sharding import NamedSharding, P, device_put


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor], causal: bool = False) -> list:
    """Exact attention over the whole sequence of the blocks `q[i]`
    [B, S_loc, NH, D], `k[i]`/`v[i]` [B, S_loc, KVH, D] (entry i's, on its
    device; entry i holds global positions [i·S_loc, (i+1)·S_loc)) →
    each entry's output block [B, S_loc, NH, D] in q's dtype, on its
    device.

    n steps: at step s entry i holds the K/V block of entry (i - s) mod n,
    scores it against its queries, and hands it on to entry i + 1.
    GQA-aware: K/V may carry fewer heads than Q (KVH | NH). The compact KVH
    blocks are what rotates; they are expanded to NH only for the local
    scores. A fully masked block (causal, a later block) adds nothing: its
    scores are -inf, and the guards keep the running max and the
    correction finite. The running max is a constant of the softmax (the
    output does not depend on it), so no gradient is taken through it."""
    n = len(q)
    if not (len(k) == len(v) == n):
        raise ValueError(f"{n} query blocks but {len(k)} key and {len(v)} value blocks")
    refuse_remote_blocks(q, k, v)
    B, S, NH, D = q[0].shape
    KVH = k[0].shape[2]
    if NH % KVH != 0:
        raise ValueError(f"query heads {NH} not divisible by KV heads {KVH}")
    rep = NH // KVH
    scale = 1.0 / math.sqrt(D)
    devs = [t.device for t in q]

    def expand(blk):  # [B, S, KVH, D] → [B, S, NH, D] (local, after the hop)
        return blk.repeat_interleave(rep, dim=2) if rep > 1 else blk

    q32 = [t.float() for t in q]
    pos = [i * S + torch.arange(S, device=d) for i, d in enumerate(devs)]
    m = [torch.full((B, NH, S), -math.inf, device=d) for d in devs]
    l = [torch.zeros((B, NH, S), device=d) for d in devs]
    acc = [torch.zeros((B, NH, S, D), device=d) for d in devs]
    k_blk, v_blk = list(k), list(v)
    for s in range(n):
        for i in range(n):
            src = (i - s) % n
            scores = torch.einsum("bqhd,bkhd->bhqk", q32[i],
                                  expand(k_blk[i]).float()) * scale
            if causal:
                hidden = pos[i][:, None] < pos[src].to(devs[i])[None, :]
                scores = scores.masked_fill(hidden, -math.inf)
            new_m = torch.maximum(m[i], scores.detach().amax(dim=-1))
            correction = torch.where(torch.isneginf(m[i]), 0.0, torch.exp(m[i] - new_m))
            probs = torch.exp(scores - torch.where(torch.isneginf(new_m), 0.0, new_m)[..., None])
            probs = torch.where(torch.isneginf(scores), 0.0, probs)
            l[i] = l[i] * correction + probs.sum(dim=-1)
            acc[i] = acc[i] * correction[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", probs, expand(v_blk[i]).float())
            m[i] = new_m
        if s < n - 1:  # the hop: entry i's block goes on to entry i + 1
            k_blk = [k_blk[(i - 1) % n].to(devs[i]) for i in range(n)]
            v_blk = [v_blk[(i - 1) % n].to(devs[i]) for i in range(n)]
    return [(a / li.clamp_min(1e-30)[..., None]).transpose(1, 2).to(qi.dtype)
            for a, li, qi in zip(acc, l, q)]


def refuse_remote_blocks(*blocks) -> None:
    """Raise where a block belongs to another process (a `Sharded`'s None
    on a mesh that spans processes): the hop between processes is not
    ported."""
    if any(t is None for b in blocks for t in b):
        raise ValueError("sequence parallelism over blocks of another process is not ported "
                         "(ROADMAP SP/PP across processes)")


def split_sequence(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """`x` [B, S, ...] split on its sequence dim over `axis` (a `Sharded`
    with spec P(None, axis)) → the blocks of the axis' entries in order,
    each on its device."""
    refuse_spanning(mesh, "sequence parallelism", "SP/PP across processes")
    placed = device_put(x, NamedSharding(mesh, P(None, axis)))
    return [placed.shards[mesh.flat_index(**{axis: i})] for i in range(mesh.shape[axis])]


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                           axis_name: str = "data", causal: bool = False) -> torch.Tensor:
    """Split q, k, v [B, S, heads, D] on the sequence dim over `axis_name`,
    run the ring, and gather the whole [B, S, NH, D] result on the mesh's
    lead entry."""
    outs = ring_attention(*(split_sequence(t, mesh, axis_name) for t in (q, k, v)),
                          causal=causal)
    return torch.cat([o.to(mesh.lead) for o in outs], dim=1)
