"""Sharding specs: how params, batches and a corpus lay out on the mesh.

The port of `symbiont_tpu/parallel/sharding.py` (`replicate`,
`batch_sharding`, `_gpt_layer_spec`, `gpt_param_sharding`, `shard_params`,
`corpus_topk`). A spec is JAX's `PartitionSpec` as plain data: a tuple
with one entry per leading dimension, an axis name where that dimension is
split over the axis, `None` where it is not; `()` replicates.

A placed value is a `Sharded`: its mesh, its spec and one shard per mesh
entry in flat order, each on that entry's device, as a `jax.Array` holds
its addressable shards. Every entry holds its own copy, also where a
mesh repeats a device, so a replica on a repeated device is as distinct
from its block's first holder as it would be on a card of its own.
Nothing here launches a kernel: the collectives
the engines need are copies between devices (`.to`) and adds, which
autograd differentiates as they stand (a `.to` is a broadcast whose
gradient is a sum), so TP and DP gradients need no backward of their own.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, NamedTuple, Optional

import torch

from symbiont_tpu_torch.models.quant import QuantTensor
from symbiont_tpu_torch.parallel.mesh import Mesh

Params = Any


def P(*axes) -> tuple:
    """A partition spec: one axis name (or None) per leading dimension."""
    return tuple(axes)


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: tuple


class Sharded:
    """A tensor laid out on a mesh: `shards[i]` is the block of the mesh's
    flat entry i, on that entry's device; `shape` the whole tensor's."""

    __slots__ = ("mesh", "spec", "shards", "shape")

    def __init__(self, mesh: Mesh, spec: tuple, shards: tuple, shape: torch.Size):
        self.mesh, self.spec, self.shards, self.shape = mesh, tuple(spec), tuple(shards), shape

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        """Device bytes of every entry's shard."""
        return sum(t.numel() * t.element_size() for t in self.shards)

    def block(self, i: int) -> tuple:
        """Which block of the whole the flat entry i holds: per dimension,
        its index along that dimension's axis (0 where unsplit)."""
        coords = self.mesh.coords(i)
        return tuple(0 if a is None else coords[a] for a in self.spec)

    def home_index(self, i: int) -> int:
        """The first entry that holds entry i's block."""
        want = self.block(i)
        return next(j for j in range(len(self.shards)) if self.block(j) == want)

    def home(self, i: int) -> torch.Tensor:
        """Entry i's block at the first entry that holds it: a train
        state's master for that block."""
        return self.shards[self.home_index(i)]

    def homes(self) -> list:
        """Each block's home shard once, in entry order."""
        return [t for i, t in enumerate(self.shards) if self.home_index(i) == i]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the mesh's lead entry by
        default), each block copied once."""
        device = torch.device(device) if device is not None else self.mesh.lead
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for i, t in enumerate(self.shards):
            if self.home_index(i) == i:
                sl = tuple(slice(j * n, (j + 1) * n) for j, n in zip(self.block(i), t.shape))
                out[sl] = t.to(device)
        return out

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.dtype}, spec={self.spec})"


def _place(t: torch.Tensor, mesh: Mesh, spec: tuple) -> Sharded:
    """`t` on `mesh` per `spec`: each entry a copy of its block on its device."""
    spec = tuple(spec)
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than a {t.ndim}-d tensor")
    for d, a in enumerate(spec):
        if a is not None and t.shape[d] % mesh.shape[a]:
            raise ValueError(f"dim {d} of {tuple(t.shape)} not divisible by "
                             f"{a}={mesh.shape[a]}")
    shards = []
    for i, dev in enumerate(mesh.device_list):
        coords = mesh.coords(i)
        sl = tuple(slice(None) if a is None else
                   slice(coords[a] * (t.shape[d] // mesh.shape[a]),
                         (coords[a] + 1) * (t.shape[d] // mesh.shape[a]))
                   for d, a in enumerate(spec))
        shards.append(t[sl].to(dev, copy=True).contiguous())
    return Sharded(mesh, spec, shards, t.shape)


def device_put(x, sharding: NamedSharding):
    """A tensor (or a `QuantTensor`: codes on the spec, scales on its last
    entry) placed per `sharding`."""
    return _place_leaf(x, sharding.mesh, sharding.spec)


def _place_leaf(x, mesh: Mesh, spec: tuple):
    if isinstance(x, QuantTensor):
        # the per-output-channel scales shard on the kernel's LAST axis
        # entry: a col-split kernel keeps its scales with their channels, a
        # row-split kernel's output channels are whole, so they replicate
        scale_spec = P(spec[-1]) if len(spec) else P()
        return QuantTensor(_place(x.q, mesh, spec), _place(x.scale, mesh, scale_spec))
    return _place(x, mesh, spec)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def replicate(mesh: Mesh, tree: Params) -> Params:
    """Every leaf whole on every mesh entry (embedding models: weights are
    small; DP wants replicas)."""
    return _map(lambda x: _place_leaf(x, mesh, P()), tree)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Dim 0 (batch) split over the data axis; everything else replicated."""
    return NamedSharding(mesh, P(axis))


def _gpt_layer_spec(arch: str) -> dict:
    """TP rules for one decoder layer: attention heads and MLP hidden split
    on 'tensor'; output projections split the contracting dim, so their
    partial products are summed over 'tensor' before the bias."""
    col = P(None, "tensor")  # [in, out] split on out
    row = P("tensor", None)  # [in, out] split on in (contraction → sum)
    vec = P("tensor")
    if arch == "gpt2":
        return {
            "ln1": {"scale": P(), "bias": P()},
            "ln2": {"scale": P(), "bias": P()},
            "q": {"kernel": col, "bias": vec},
            "k": {"kernel": col, "bias": vec},
            "v": {"kernel": col, "bias": vec},
            "o": {"kernel": row, "bias": P()},
            "mlp": {
                "in": {"kernel": col, "bias": vec},
                "out": {"kernel": row, "bias": P()},
            },
        }
    return {
        "ln1": {"scale": P()},
        "ln2": {"scale": P()},
        "q": {"kernel": col},
        "k": {"kernel": col},
        "v": {"kernel": col},
        "o": {"kernel": row},
        "mlp": {
            "gate": {"kernel": col},
            "up": {"kernel": col},
            "down": {"kernel": row},
        },
    }


def gpt_param_sharding(mesh: Mesh, params: Params, arch: str = "gpt2") -> Params:
    """Spec tree for decoder LM params (megatron-style TP). The vocab dim
    splits only when it divides the tensor axis; otherwise the embedding
    and head replicate (odd vocabs like the 257-entry byte tokenizer must
    still serve)."""
    layer_spec = _gpt_layer_spec(arch)
    tp = mesh.shape.get("tensor", 1)
    vocab_divides = params["wte"].shape[0] % tp == 0
    spec: dict = {
        "wte": P("tensor", None) if vocab_divides else P(),
        "layers": [layer_spec for _ in params["layers"]],
        "ln_f": {k: P() for k in params["ln_f"]},
    }
    if "wpe" in params:
        spec["wpe"] = P()
    if "lm_head" in params:
        spec["lm_head"] = {"kernel": P(None, "tensor") if vocab_divides else P()}
    return spec


def shard_params(mesh: Mesh, params: Params, spec_tree: Params) -> Params:
    """Place params on the mesh per a spec tree. `QuantTensor` leaves shard
    too: the codes take the kernel's spec and the scales its last entry,
    which is what lets `quantize=int8` compose with TP decode."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        if isinstance(p, list):
            return [walk(a, b) for a, b in zip(p, s, strict=True)]
        return _place_leaf(p, mesh, s)

    return walk(params, spec_tree)


def mesh_of(tree) -> Optional[Mesh]:
    """The mesh of a placed tree (its first leaf's), or None for a plain one."""
    leaf = tree
    while isinstance(leaf, (dict, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    leaf = leaf.q if isinstance(leaf, QuantTensor) else leaf
    return leaf.mesh if isinstance(leaf, Sharded) else None


def local_tree(tree: Params, i: int) -> Params:
    """The plain tree the mesh's flat entry i holds."""
    def pick(x):
        if isinstance(x, QuantTensor) and isinstance(x.q, Sharded):
            return QuantTensor(x.q.shards[i], x.scale.shards[i])
        return x.shards[i] if isinstance(x, Sharded) else x

    return _map(pick, tree)


def gather_tree(tree: Params, device=None) -> Params:
    """A placed tree back to whole tensors on one device."""
    def whole(x):
        if isinstance(x, QuantTensor) and isinstance(x.q, Sharded):
            return QuantTensor(x.q.gather(device), x.scale.gather(device))
        return x.gather(device) if isinstance(x, Sharded) else x

    return _map(whole, tree)


def leaf_tensors(x) -> list:
    """The device tensors one leaf holds (a `QuantTensor`'s codes and
    scales, every entry's shard of a `Sharded` leaf)."""
    if isinstance(x, QuantTensor):
        return leaf_tensors(x.q) + leaf_tensors(x.scale)
    if isinstance(x, Sharded):
        return list(x.shards)
    return [x]


def shard_topk(shard: torch.Tensor, query: torch.Tensor, n_valid, base: int, k: int):
    """One corpus shard's exact top-k with GLOBAL row ids: the store's
    `cosine_topk` over the shard's rows, whose first is global row `base`."""
    # the store imports this module, so its search is imported here
    from symbiont_tpu_torch.memory.vector_store import cosine_topk

    dev = shard.device
    nv = n_valid.to(dev) if isinstance(n_valid, torch.Tensor) else n_valid
    top, idx = cosine_topk(shard, query.to(dev), nv - base, k)
    return top, idx + base


def corpus_topk(mesh: Mesh, corpus: Sharded, query: torch.Tensor, n_valid, k: int,
                axis: str = "data", local=None):
    """Corpus-sharded exact top-k: per-shard top-k + a merge on the lead.

    `corpus` is [cap, D] row-split over `axis` (cap divisible by the axis
    size, which `VectorStore._capacity` guarantees), `query` a [D] vector,
    `n_valid` the count of real rows. Each shard scores its own rows on its
    own device and keeps its local top-k with global row ids; the merge
    sorts the [n_shards × k] candidates. Only k candidates a shard cross
    devices. Order is the single-device one exactly: each shard breaks ties
    by row, shards concatenate in global row order, and the merge's sort is
    stable. `local(d)`: the callable that runs shard d's search
    (`(query, n_valid) → (scores, ids)`, an executable on its device), by
    default `shard_topk` on it."""
    nd = mesh.shape[axis]
    cap = corpus.shape[0]
    if cap % nd:
        raise ValueError(f"corpus capacity {cap} not divisible by {axis}={nd}")
    rows = cap // nd
    k_local = min(k, rows)
    lead = mesh.lead
    cand_s, cand_i = [], []
    for d in range(nd):
        if local is not None:
            s, i = local(d)(query, n_valid)
        else:
            shard = corpus.shards[mesh.flat_index(**{axis: d})]
            s, i = shard_topk(shard, query, n_valid, d * rows, k_local)
        cand_s.append(s.to(lead))
        cand_i.append(i.to(lead))
    s, i = torch.cat(cand_s), torch.cat(cand_i)
    top, pos = torch.sort(s, descending=True, stable=True)
    return top[:k], i[pos[:k]]


def sum_to(parts, device) -> torch.Tensor:
    """The sum of partial results over the mesh, on `device`, in entry
    order (the psum the JAX package's XLA inserts)."""
    return reduce(torch.add, (p.to(device) for p in parts))
