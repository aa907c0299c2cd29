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
blocks, as `ring_attention` does, and each all-to-all is a copy between
devices (`.to`) for each pair of this process's entries and a
concatenation, which autograd carries backward. Over a mesh that spans
processes (`mesh=`) a process holds only its entries' blocks, and the
pieces between entries of different processes cross in one
`torch.distributed` all-to-all a trade (`sharding.trade`; q, k and v
stacked, so one trade carries all three), whose backward is the inverse
all-to-all of the gradients. The inner attention is the port's flash
attention in the `[B, heads, S, D]` layout, which is what JAX's docstring
says drops in there: on CUDA tensors the B1 forward, and under autograd
B4's fused backward, B2 then B3 (K/V are at the query heads' count here,
since the all-to-all splits the head dim); on CPU tensors their plain
versions.

Trade-offs against the ring (why both ship): Ulysses needs NH divisible
by the axis size and moves Q, K, V and the output once each; the ring
moves only K/V, n - 1 times each.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from symbiont_tpu_torch.ops.flash_attention import flash_attention
from symbiont_tpu_torch.parallel.mesh import Mesh
from symbiont_tpu_torch.parallel.ring_attention import split_sequence
from symbiont_tpu_torch.parallel.sharding import Line, trade


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


def ulysses_attention(q: Sequence[Optional[torch.Tensor]], k: Sequence[Optional[torch.Tensor]],
                      v: Sequence[Optional[torch.Tensor]], causal: bool = False,
                      mesh: Optional[Mesh] = None, axis: str = "data") -> list:
    """Exact attention over the whole sequence of the per-entry blocks
    q[i], k[i], v[i] [B, S_loc, NH, D] (entry i's, on its device, in
    sequence order) → each entry's output block [B, S_loc, NH, D] on its
    device. Requires NH % n == 0 (n = the number of entries). Over `mesh`
    (the blocks of `axis`' line through entry 0) another process's blocks
    are None, and so are their outputs here; every process of the line
    makes the call."""
    n = len(q)
    line = Line(mesh, axis, n)
    if len(line) != n:
        raise ValueError(f"{n} blocks for the {len(line)} entries of the {axis} line")
    local = line.local
    if any(q[i] is None or k[i] is None or v[i] is None for i in local):
        raise ValueError(f"a block of this process's entries {local} is missing")
    NH = q[local[0]].shape[2]
    if NH % n != 0:
        raise ValueError(f"num_heads {NH} not divisible by axis size {n}")
    h, S_loc = NH // n, q[local[0]].shape[1]
    devs = {i: q[i].device for i in local}
    chain = line.chain([q[i] for i in local] + [k[i] for i in local] + [v[i] for i in local])
    qkv = {i: torch.stack([q[i], k[i], v[i]]) for i in local}  # [3, B, S_loc, NH, D]
    # entry j's head slice of every entry's block, in entry order (= sequence order)
    got = trade(line, chain, qkv, lambda x, j: x[:, :, :, j * h:(j + 1) * h], devs)
    heads = {j: torch.cat([got[(i, j)] for i in range(n)], dim=2).transpose(2, 3).contiguous()
             for j in local}  # [3, B, h, S, D]: entry j's heads over the whole sequence
    outs = {j: flash_attention(heads[j][0], heads[j][1], heads[j][2], causal=causal)
            for j in local}  # [B, h, S, D]
    # the inverse trade: entry i's sequence block of every head shard
    back = trade(line, chain, outs, lambda o, i: o[:, :, i * S_loc:(i + 1) * S_loc], devs)
    res = [None] * n
    for i in local:
        res[i] = torch.cat([back[(j, i)] for j in range(n)], dim=1).transpose(1, 2)
    if chain is not None:
        res[local[0]] = chain.close(res[local[0]])
    return res


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                              axis_name: str = "data", causal: bool = False) -> torch.Tensor:
    """Split q, k, v [B, S, NH, D] on the sequence dim over `axis_name`
    and run Ulysses attention → the whole [B, S, NH, D] result on the
    mesh's lead entry; over a mesh that spans processes a `Sharded` over
    the sequence axis holding this process's blocks (`Line.join`)."""
    outs = ulysses_attention(*(split_sequence(t, mesh, axis_name) for t in (q, k, v)),
                             causal=causal, mesh=mesh, axis=axis_name)
    return Line(mesh, axis_name).join(outs, 1, q.shape)
