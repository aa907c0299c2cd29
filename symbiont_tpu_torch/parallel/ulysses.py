"""Ulysses-style sequence parallelism: all-to-all head/sequence re-sharding.

The port of `symbiont_tpu/parallel/ulysses.py` (`_full_attention`,
`ulysses_attention`, `ulysses_attention_sharded`), the second of the two
sequence-parallel schemes (the first, ring attention, is in
`ring_attention.py`). Where the ring keeps queries local and streams K/V
blocks round the mesh, Ulysses re-shards twice: entering attention each
entry trades its sequence block for a head shard (so it holds the WHOLE
sequence for NH/n heads and runs full attention), and leaving attention
the inverse trade restores the sequence blocks.

The port has no `shard_map`: `ulysses_attention` takes the per-entry
blocks, as `ring_attention` does, and each all-to-all is n copies between
devices (`.to`) and a concatenation, which autograd carries backward. The
inner attention is the port's flash attention in the `[B, heads, S, D]`
layout, which is what JAX's docstring says drops in there: on CUDA tensors
the B1 forward, and under autograd B4's fused backward, B2 then B3 (K/V are
at the query heads' count here, since the all-to-all splits the head
dim); on CPU tensors their plain versions.

Trade-offs against the ring (why both ship): Ulysses needs NH divisible
by the axis size and moves Q, K, V and the output once each; the ring
moves only K/V, n - 1 times each.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from symbiont_tpu_torch.ops.flash_attention import flash_attention
from symbiont_tpu_torch.parallel.mesh import Mesh
from symbiont_tpu_torch.parallel.ring_attention import refuse_remote_blocks, split_sequence


def _full_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Plain dense attention, float32 statistics, [B, S, H, D] layout (the
    tests' dense reference)."""
    S, D = q.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        visible = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~visible, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def ulysses_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                      v: Sequence[torch.Tensor], causal: bool = False) -> list:
    """Exact attention over the whole sequence of the per-entry blocks
    q[i], k[i], v[i] [B, S_loc, NH, D] (entry i's, on its device, in
    sequence order) → each entry's output block [B, S_loc, NH, D] on its
    device. Requires NH % n == 0 (n = the number of entries)."""
    n = len(q)
    refuse_remote_blocks(q, k, v)
    NH = q[0].shape[2]
    if NH % n != 0:
        raise ValueError(f"num_heads {NH} not divisible by axis size {n}")
    h, S_loc = NH // n, q[0].shape[1]
    devs = [t.device for t in q]

    def to_heads(x, j):
        """Entry j's head slice of every entry's block, gathered in entry
        order (= sequence order) → [B, h, S, D] on j's device."""
        return torch.cat([x[i][:, :, j * h:(j + 1) * h].to(devs[j]) for i in range(n)],
                         dim=1).transpose(1, 2).contiguous()

    outs = [flash_attention(to_heads(q, j), to_heads(k, j), to_heads(v, j), causal=causal)
            for j in range(n)]  # [B, h, S, D], entry j's heads over the whole sequence
    # the inverse trade: entry i's sequence block of every head shard
    return [torch.cat([outs[j][:, :, i * S_loc:(i + 1) * S_loc].to(devs[i]) for j in range(n)],
                      dim=1).transpose(1, 2) for i in range(n)]


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                              axis_name: str = "data", causal: bool = False) -> torch.Tensor:
    """Split q, k, v [B, S, NH, D] on the sequence dim over `axis_name`,
    run Ulysses attention, and gather the whole [B, S, NH, D] result on
    the mesh's lead entry."""
    outs = ulysses_attention(*(split_sequence(t, mesh, axis_name) for t in (q, k, v)),
                             causal=causal)
    return torch.cat([o.to(mesh.lead) for o in outs], dim=1)
