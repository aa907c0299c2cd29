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

Over a mesh that spans processes (`parallel/mesh.init_distributed`) a
`Sharded` holds only this process's shards, as a `jax.Array` holds its
addressable ones: another process's entries are None, and `_place`
copies only local blocks. A block's master (`home`) is its first local
holder, so every process that holds a block keeps a master of its own.
`gather` fetches the blocks no local entry holds from their first holder
(a collective: every process of the mesh calls it). `sum_to` over a line
that crosses processes adds the local partials and then all-reduces over
the line's group (`all_reduce`, an autograd Function of the port's own:
its backward is the all-reduce of the gradient, so each process's
gradient of a value every process holds is a partial whose sum over the
processes is the whole; `train/trainer.py` seeds each loss once and sums
the replicated masters' gradients over their holders to match).

The sequence- and pipeline-parallel paths move blocks between the
processes of one line of an axis (`Line`) through a `Chain`: each hop
(`Group.exchange`) or all-to-all (`Group.all_to_all`) is an autograd
Function whose backward makes the reverse trade of the gradients, and
every trade of one call takes the token its previous trade returned, so
the backward makes them in the reverse of the forward's order in every
process, whatever order autograd would take independent branches in.
"""

from __future__ import annotations

from functools import reduce
from typing import Any, NamedTuple, Optional, Sequence

import torch

from symbiont_tpu_torch.models.quant import QuantTensor
from symbiont_tpu_torch.parallel.mesh import Group, Mesh

Params = Any


def P(*axes) -> tuple:
    """A partition spec: one axis name (or None) per leading dimension."""
    return tuple(axes)


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: tuple


class Sharded:
    """A tensor laid out on a mesh: `shards[i]` is the block of the mesh's
    flat entry i, on that entry's device (None where the entry belongs to
    another process); `shape` the whole tensor's."""

    __slots__ = ("mesh", "spec", "shards", "shape")

    def __init__(self, mesh: Mesh, spec: tuple, shards: tuple, shape: torch.Size):
        self.mesh, self.spec, self.shards, self.shape = mesh, tuple(spec), tuple(shards), shape

    @property
    def local(self) -> list:
        """This process's shards, in entry order."""
        return [t for t in self.shards if t is not None]

    @property
    def dtype(self) -> torch.dtype:
        return self.local[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.local[0].device

    @property
    def nbytes(self) -> int:
        """Device bytes of this process's shards."""
        return sum(t.numel() * t.element_size() for t in self.local)

    def block(self, i: int) -> tuple:
        """Which block of the whole the flat entry i holds: per dimension,
        its index along that dimension's axis (0 where unsplit)."""
        coords = self.mesh.coords(i)
        return tuple(0 if a is None else coords[a] for a in self.spec)

    def home_index(self, i: int) -> Optional[int]:
        """The first local entry that holds entry i's block (None where no
        local entry does)."""
        want = self.block(i)
        return next((j for j in self.mesh.local_entries if self.block(j) == want), None)

    def home(self, i: int) -> torch.Tensor:
        """Entry i's block at the first local entry that holds it: a train
        state's master for that block."""
        return self.shards[self.home_index(i)]

    def homes(self) -> list:
        """Each local block's home shard once, in entry order."""
        return [self.shards[i] for i in self.mesh.local_entries if self.home_index(i) == i]

    def holders(self, i: int) -> Optional[Group]:
        """The group of the processes that hold entry i's block (its
        replicas over the axes the spec does not split), or None where
        one process holds every copy."""
        split = {a for a in self.spec if a is not None}
        return self.mesh.group([a for a in self.mesh.axis_names if a not in split], i)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the mesh's lead entry by
        default), each block copied once: from its local home where this
        process holds it, else broadcast over the mesh's group from the
        first process that holds it. Over a mesh that spans processes this
        is a collective: every process of the mesh calls it."""
        mesh = self.mesh
        device = torch.device(device) if device is not None else mesh.lead
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        whole = mesh.group(mesh.axis_names, 0)
        size = [n // mesh.shape[a] if a is not None else n
                for n, a in zip(self.shape, self.spec + (None,) * (self.ndim - len(self.spec)))]
        seen = set()
        for i in range(mesh.size):
            b = self.block(i)
            if b in seen:
                continue
            seen.add(b)
            sl = tuple(slice(j * n, (j + 1) * n) for j, n in zip(b, size))
            j = self.home_index(i)
            held = {mesh.process_index(k) for k in range(mesh.size) if self.block(k) == b}
            if whole is not None and len(held) < len(whole.ranks):
                src = min(held)
                buf = (self.shards[j].detach().clone(memory_format=torch.contiguous_format)
                       if mesh.process == src
                       else torch.empty(size, dtype=self.dtype, device=mesh.lead))
                whole.broadcast_(buf, src)
                if j is None:
                    out[sl] = buf.to(device)
            if j is not None:
                out[sl] = self.shards[j].to(device)
        return out

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.dtype}, spec={self.spec})"


def _place(t: torch.Tensor, mesh: Mesh, spec: tuple) -> Sharded:
    """`t` on `mesh` per `spec`: each local entry a copy of its block on
    its device (another process's entries None)."""
    spec = tuple(spec)
    if len(spec) > t.ndim:
        raise ValueError(f"spec {spec} has more entries than a {t.ndim}-d tensor")
    for d, a in enumerate(spec):
        if a is not None and t.shape[d] % mesh.shape[a]:
            raise ValueError(f"dim {d} of {tuple(t.shape)} not divisible by "
                             f"{a}={mesh.shape[a]}")
    shards = []
    for i, dev in enumerate(mesh.device_list):
        if not mesh.is_local(i):
            shards.append(None)
            continue
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
    scales, every local entry's shard of a `Sharded` leaf)."""
    if isinstance(x, QuantTensor):
        return leaf_tensors(x.q) + leaf_tensors(x.scale)
    if isinstance(x, Sharded):
        return x.local
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


def search_line(mesh: Mesh, axis: str = "data") -> tuple:
    """The line of `axis` a row-split corpus is searched on: the one
    through this process's lead entry (entry 0's on a mesh of one
    process). Over a mesh that spans processes every process of that line
    must lead on it, so that all of them search the same line and meet in
    its group's all-gather; a layout where one does not raises. → (the
    line's flat entries in shard order, process → the shards it holds)."""
    coords = mesh.coords(mesh.local_entries[0] if mesh.local_entries else 0)
    line = [mesh.flat_index(**dict(coords, **{axis: d})) for d in range(mesh.shape[axis])]
    held: dict = {}
    for d, e in enumerate(line):
        held.setdefault(mesh.process_index(e), []).append(d)
    for p in held:
        first = next(i for i, q in enumerate(mesh.processes.flat) if q == p)
        if first not in line:
            raise ValueError(f"process {p} leads on entry {first}, off the {axis} line "
                             f"{line} a corpus is searched on: {mesh}")
    return line, held


def corpus_topk(mesh: Mesh, corpus: Sharded, query: torch.Tensor, n_valid, k: int,
                axis: str = "data", local=None, layout=None):
    """Corpus-sharded exact top-k: per-shard top-k + a merge on the lead.

    `corpus` is [cap, D] row-split over `axis` (cap divisible by the axis
    size, which `VectorStore._capacity` guarantees), `query` a [D] vector,
    `n_valid` the count of real rows. Each shard of the line
    (`search_line`) scores its own rows on its own device and keeps its
    local top-k with global row ids; the merge sorts the [n_shards × k]
    candidates. Only k candidates a shard cross devices. Order is the
    single-device one exactly: each shard breaks ties by row, shards
    concatenate in global row order, and the merge's sort is stable.
    `local(d)`: the callable that runs shard d's search (`(query,
    n_valid) → (scores, ids)`, an executable on its device), by default
    `shard_topk` on it. `layout`: `search_line`'s, where the caller holds
    it (computed here otherwise).

    Over a line that crosses processes each process searches the shards
    it holds, and the candidates reach every process by one all-gather on
    the line's group (scores and ids as float64, both exact there); every
    process then merges all of them in global row order, so each returns
    the same hits."""
    nd = mesh.shape[axis]
    cap = corpus.shape[0]
    if cap % nd:
        raise ValueError(f"corpus capacity {cap} not divisible by {axis}={nd}")
    rows = cap // nd
    k_local = min(k, rows)
    lead = mesh.lead
    line, held = layout if layout is not None else search_line(mesh, axis)
    cand_s, cand_i = {}, {}
    for d, entry in enumerate(line):
        if not mesh.is_local(entry):
            continue
        if local is not None:
            s, i = local(d)(query, n_valid)
        else:
            s, i = shard_topk(corpus.shards[entry], query, n_valid, d * rows, k_local)
        cand_s[d], cand_i[d] = s.to(lead), i.to(lead)
    group = mesh.group((axis,), line[0])
    if group is not None:
        # one all-gather of every process's [n_held, 2, k_local] candidates,
        # padded to the most shards a process of the line holds
        most = max(len(ds) for ds in held.values())
        mine = torch.full((most, 2, k_local), float("-inf"), dtype=torch.float64, device=lead)
        for j, d in enumerate(held[mesh.process]):
            mine[j, 0], mine[j, 1] = cand_s[d].double(), cand_i[d].double()
        every = group.all_gather(mine)
        for p, got in zip(group.ranks, every):
            for j, d in enumerate(held[p]):
                cand_s[d], cand_i[d] = got[j, 0].float(), got[j, 1].long()
    s = torch.cat([cand_s[d] for d in range(nd)])
    i = torch.cat([cand_i[d] for d in range(nd)])
    top, pos = torch.sort(s, descending=True, stable=True)
    return top[:k], i[pos[:k]]


class _AllReduce(torch.autograd.Function):
    """The sum of `x` over a group's processes; its backward is the sum of
    the gradient over them. The port's own Function, not
    `torch.distributed.nn.functional.all_reduce`: its collective is the
    `Group`'s, which stages CUDA tensors through host memory under gloo,
    and its backward is fixed here whatever the torch version."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone(memory_format=torch.contiguous_format)), None


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """`x` summed over `group`'s processes, under autograd (`_AllReduce`)."""
    return _AllReduce.apply(x, group)


def sum_to(parts, device, group: Optional[Group] = None) -> torch.Tensor:
    """The sum of partial results over the mesh, on `device`, in entry
    order (the psum the JAX package's XLA inserts); with `group` (a line
    that crosses processes) this process's partials summed, then
    all-reduced over the group."""
    total = reduce(torch.add, (p.to(device) for p in parts))
    return total if group is None else all_reduce(total, group)


class Line:
    """The entries of `axis` through the mesh's entry 0 (every other axis
    at index 0), in axis order: the line a sequence or a pipeline is split
    over. `owners[i]` is the process of position i, `local` this process's
    positions, `group` the processes' `Group` (None where one process
    holds the whole line). Without a mesh, `n` positions all of this
    process. Over a mesh that spans processes every process of the mesh
    must hold a position of the line, and each local entry off the line
    must share its axis index with a local one on it (so a result split
    over the axis is whole in each process that holds a block of it)."""

    def __init__(self, mesh: Optional[Mesh], axis: str, n: Optional[int] = None):
        self.mesh, self.axis = mesh, axis
        if mesh is None:
            self.entries, self.owners, self.me, self.group = list(range(n)), [0] * n, 0, None
            self.local = list(range(n))
            return
        self.entries = [mesh.flat_index(**{axis: i}) for i in range(mesh.shape[axis])]
        self.owners = [mesh.process_index(e) for e in self.entries]
        self.me = mesh.process
        self.local = [i for i, p in enumerate(self.owners) if p == self.me]
        self.group = mesh.group((axis,), self.entries[0])
        if mesh.spans_processes:
            off = [i for i in mesh.local_entries
                   if not mesh.is_local(self.entries[mesh.coords(i)[axis]])]
            if not self.local or off:
                raise ValueError(f"process {self.me} holds no entry of the {axis} line "
                                 f"{self.entries} through entry 0, or an entry off it whose "
                                 f"block lies in another process: {mesh}")

    def __len__(self) -> int:
        return len(self.entries)

    def is_local(self, i: int) -> bool:
        return self.owners[i] == self.me

    def chain(self, like: Sequence[Optional[torch.Tensor]]) -> Optional["Chain"]:
        """A `Chain` over the line's group for one call on the blocks
        `like` (None where another process holds one), its token on this
        process's first block's device and taking gradients where
        autograd records and a local block takes them; None where one
        process holds the whole line."""
        if self.group is None:
            return None
        mine = [t for t in like if t is not None]
        return Chain(self.group, mine[0].device,
                     torch.is_grad_enabled() and any(t.requires_grad for t in mine))

    def join(self, blocks: Sequence[Optional[torch.Tensor]], dim: int,
             shape: torch.Size):
        """The per-position results `blocks` [.., S/n, ..] split on `dim`:
        joined on the mesh's lead entry where one process holds the line
        (a tensor of `shape`), else a `Sharded` over the mesh with spec
        P(None x dim, axis) holding this process's blocks (each local
        entry off the line a copy of its axis index's block), as JAX
        returns a global array; its `gather()` is the whole."""
        mesh = self.mesh
        if mesh is None or not mesh.spans_processes:
            lead = mesh.lead if mesh is not None else blocks[0].device
            return torch.cat([b.to(lead) for b in blocks], dim=dim)
        shards = []
        for e, dev in enumerate(mesh.device_list):
            if not mesh.is_local(e):
                shards.append(None)
                continue
            i = mesh.coords(e)[self.axis]
            b = blocks[i]
            shards.append(b if self.entries[i] == e else b.to(dev, copy=True))
        return Sharded(mesh, (None,) * dim + (self.axis,), shards, shape)


class Chain:
    """The cross-process trades of one call over a `Group`, in the order
    it makes them. Each trade takes the token the previous one returned
    and returns the next: the backward's trades then run in the reverse
    of the forward's order in every process (each waits for the gradient
    of its token from the trade after it), so two processes that make
    the same calls pair the same trades, whatever order autograd would
    take independent branches in. `close(x)` adds the last token (a
    zero) to a value the caller's loss depends on, which puts every
    trade of the call on the backward's path, also in a process whose
    own loss does not read what it received."""

    def __init__(self, group: Group, device, grad: bool):
        self.group = group
        self.token = torch.zeros((), device=device, requires_grad=grad)

    def exchange(self, sends, recvs) -> list:
        """`Group.exchange` under autograd: sends (tensor, dst rank),
        recvs (src rank, (shape, dtype, device)) → the received tensors."""
        out = _Exchange.apply(self.group, tuple(d for _, d in sends), tuple(recvs),
                              self.token, *(t for t, _ in sends))
        self.token = out[0]
        return list(out[1:])

    def all_to_all(self, flat: torch.Tensor, send_sizes, recv_sizes) -> torch.Tensor:
        """`Group.all_to_all` under autograd."""
        self.token, out = _AllToAll.apply(self.group, tuple(send_sizes), tuple(recv_sizes),
                                          self.token, flat)
        return out

    def close(self, x: torch.Tensor) -> torch.Tensor:
        """x plus the last token (0) where the chain takes gradients."""
        return x + self.token.to(x.device) if self.token.requires_grad else x


class _Exchange(torch.autograd.Function):
    """One `Group.exchange` of a `Chain`: its backward sends each received
    tensor's gradient back to its sender and receives each sent tensor's
    gradient from its receiver, in one exchange."""

    @staticmethod
    def forward(ctx, group, dsts, recvs, token, *sends):
        ctx.group, ctx.dsts, ctx.srcs = group, dsts, tuple(src for src, _ in recvs)
        ctx.sent = tuple((t.shape, t.dtype, t.device) for t in sends)
        got = group.exchange(list(zip(sends, dsts)),
                             [(src, torch.empty(shape, dtype=dtype, device=dev))
                              for src, (shape, dtype, dev) in recvs])
        return (torch.zeros_like(token), *got)

    @staticmethod
    def backward(ctx, g_token, *g_got):
        grads = ctx.group.exchange(
            list(zip(g_got, ctx.srcs)),
            [(dst, torch.empty(shape, dtype=dtype, device=dev))
             for dst, (shape, dtype, dev) in zip(ctx.dsts, ctx.sent)])
        return (None, None, None, torch.zeros_like(g_token), *grads)


class _AllToAll(torch.autograd.Function):
    """One `Group.all_to_all` of a `Chain`: its backward is the inverse
    all-to-all of the gradient (each piece's gradient back to its
    sender)."""

    @staticmethod
    def forward(ctx, group, send_sizes, recv_sizes, token, flat):
        ctx.group, ctx.send_sizes, ctx.recv_sizes = group, send_sizes, recv_sizes
        return torch.zeros_like(token), group.all_to_all(flat, send_sizes, recv_sizes)

    @staticmethod
    def backward(ctx, g_token, g):
        return (None, None, None, torch.zeros_like(g_token),
                ctx.group.all_to_all(g, ctx.recv_sizes, ctx.send_sizes))


def trade(line: Line, chain: Optional[Chain], blocks: dict, cut, devices: dict) -> dict:
    """An all-to-all over the line: position i's piece for position j is
    `cut(blocks[i], j)` (one shape for every pair) → {(i, j): that piece}
    for each local j and every i, on j's device (`devices[j]`). Pieces
    between two local positions are copies; the rest cross in one
    all-to-all of the chain, each process's pieces for another packed in
    (i, j) order."""
    n, local = len(line), line.local
    got = {(i, j): cut(blocks[i], j).to(devices[j]) for i in local for j in local}
    if chain is None:
        return got
    like = cut(blocks[local[0]], local[0])
    lead = like.device
    ranks = [r if r != line.me else None for r in line.group.ranks]  # no piece to itself
    send = [[cut(blocks[i], j).reshape(-1).to(lead) for i in local for j in range(n)
             if line.owners[j] == r] for r in ranks]
    take = [[(i, j) for i in range(n) if line.owners[i] == r for j in local] for r in ranks]
    flat = torch.cat([t for ts in send for t in ts]) if any(send) else like.new_zeros(0)
    out = chain.all_to_all(flat, [sum(t.numel() for t in ts) for ts in send],
                           [len(ps) * like.numel() for ps in take])
    for (i, j), piece in zip([p for ps in take for p in ps], out.split(like.numel())):
        got[(i, j)] = piece.view(like.shape).to(devices[j])
    return got
