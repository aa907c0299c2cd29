"""Decoder LMs for generation: the GPT-2 layout and the Llama/TinyLlama one.

A port of `symbiont_tpu/models/gpt.py`, function for function, on the same
parameter tree (a nested dict of tensors, linear kernels `[in, out]`, so
every projection is `x @ W + b`; `models/bridge.py` turns a JAX tree into
this one, `models/convert.py` a checkpoint):

- GPT-2: learned positions, LayerNorm, tanh GELU (`gelu_new`), biases;
  Llama: RoPE (half-split, angles in float32), RMSNorm, SwiGLU and GQA;
- norms take float32 statistics and return the compute dtype; the bf16
  softmax stays bf16, the float32 one float32;
- a static-shape KV cache `[L, B, T, kv_heads, head_dim]` written in place,
  S new tokens at cache indices `[length, length + S)`, `length` a host int
  or a 0-d device tensor (JAX's `length: jax.Array`); `decode_chunk` and
  the spec rounds run at a device one (a host length becomes one and comes
  back as the caller's kind), so they have no host value in them and can
  be CUDA graphs, on every layout; `kv_quant="int8"`
  keeps int8 codes with one float32 scale per (position, kv head); the
  paged layout (`kv/paged.py`) keeps K/V in a shared page pool, scattered
  there through a page table and gathered back into the dense layout's
  `[B, T, kv_heads, head_dim]` element for element, so the attention below
  is shared and paged decode is token-identical to dense;
- GQA as a 5-D einsum that groups query heads on their kv head, no repeat;
  causality runs over cache indices, padding slots masked by `kv_valid`;
- `attn_impl="flash"`: a prefill (S > 1 against an empty cache, length 0)
  runs the CUDA flash-attention kernel (`ops/flash_attention.py`), causal,
  GQA inside, on CUDA tensors, and its plain version on CPU ones; every
  other call (decode steps, and the S > 1 forwards of speculative decoding
  over a filled cache) reads the cache with the plain path. The JAX
  package takes its kernel whenever S > 1, which attends over the S fresh
  tokens only; the port does not (ROADMAP, "Facts a parity test meets");
- sampling is Gumbel-max over an explicit `torch.Generator`: per-row
  temperature (greedy at ≤ 0) and an exact per-row top-k threshold inside a
  power-of-two bucket. Sampled tokens cannot match the JAX package's
  threefry draws; greedy ones do.

The decode loop runs every one of its steps and masks finished rows, as the
JAX `lax.scan` does, so it never waits on the device between steps.
`merge_rows` splices freshly prefilled rows into a running decode at a
chunk boundary (continuous batching), in place, for all three layouts.
Speculative decoding (`spec_first`, `draft_chunk`, `verify_chunk`,
`ingest_pending`, `track_chunk`) drafts k greedy tokens on a small model's
own dense cache and scores all k+1 positions with one target forward.

Tensor parallelism (A15 stage 1): `forward` over a tree placed by
`parallel/sharding.shard_params` runs each tensor shard's heads and MLP
width on its own device and sums the row-split projections' partial
products on the lead; a plain tree is the case of one shard. The KV cache
of a placed tree is a `TPCache` of one cache per shard. `prefill`,
`decode_chunk` and `merge_rows` take such a tree and cache as they take a
plain one. Over a mesh that spans processes (A15 multi-host) a process
runs the tensor shards it holds, and the sums reach the row's other
processes through its tensor line's group; only the cache-free training
forward is ported there.

The cache-free training forwards of `parallel/context.py` (sequence
parallel) and `parallel/pipeline.py` (pipeline parallel) are built from
`qkv_proj` and `block_nocache`; `_block` is `block_nocache` with the
cache-threading attention and the tensor shards' sums plugged in, so the
per-arch block math has one home.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from symbiont_tpu_torch.kv import paged as _paged
from symbiont_tpu_torch.kv.paged import PagedKVCache
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.ops.flash_attention import MASK_NEG, flash_attention
from symbiont_tpu_torch.parallel.mesh import axis_size
from symbiont_tpu_torch.parallel.sharding import mesh_of, sum_to

Params = Any


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA (llama); None → num_heads
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    arch: str = "gpt2"  # "gpt2" | "llama"
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"
    # "xla" = plain torch attention (the JAX package's name); "flash" = the
    # CUDA kernel for a prefill against an empty cache
    attn_impl: str = "xla"
    # KV-cache storage: "none" = compute-dtype slabs, "int8" = QuantKVCache
    kv_quant: str = "none"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_hf(cfg: dict) -> "GPTConfig":
        mt = cfg.get("model_type", "gpt2")
        if mt == "gpt2":
            return GPTConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg.get("n_embd", 768),
                num_layers=cfg.get("n_layer", 12),
                num_heads=cfg.get("n_head", 12),
                intermediate_size=cfg.get("n_inner") or 4 * cfg.get("n_embd", 768),
                max_position_embeddings=cfg.get("n_positions", 1024),
                layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                arch="gpt2",
            )
        if mt in ("llama", "mistral"):
            return GPTConfig(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                num_kv_heads=cfg.get("num_key_value_heads"),
                intermediate_size=cfg["intermediate_size"],
                max_position_embeddings=cfg.get("max_position_embeddings", 2048),
                layer_norm_eps=cfg.get("rms_norm_eps", 1e-5),
                arch="llama",
                rope_theta=cfg.get("rope_theta", 10000.0),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        raise ValueError(f"unsupported model_type {mt!r}")


class KVCache(NamedTuple):
    """Static-shape per-layer cache: k/v [L, B, max_len, kv_heads,
    head_dim]; `length` is the number of slots written: a host int, or a
    0-d int64 device tensor (JAX's `length: jax.Array`), with which a
    forward writes its K/V at a slot index held on the device and builds
    its mask there, so the step has no host value in it and a CUDA graph
    can replay it at any slot (`decode_chunk` decodes so)."""

    k: torch.Tensor
    v: torch.Tensor
    length: Any


class QuantKVCache(NamedTuple):
    """The int8 cache (`kv_quant="int8"`): int8 k/v slabs, one float32
    scale per (layer, batch, position, kv head); quantize-on-append,
    dequant-on-attend."""

    k: torch.Tensor        # int8 [L, B, T, kv_heads, head_dim]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [L, B, T, kv_heads]
    v_scale: torch.Tensor
    length: Any  # a host int or a 0-d device tensor, as KVCache's


def init_cache(cfg: GPTConfig, batch: int, max_len: int, dtype: torch.dtype,
               device=None):
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        def z(s, dt):
            return torch.zeros(s, dtype=dt, device=device)

        return QuantKVCache(z(shape, torch.int8), z(shape, torch.int8),
                            z(shape[:-1], torch.float32), z(shape[:-1], torch.float32), 0)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


class TPCache(NamedTuple):
    """The KV cache of a tensor-parallel forward: one dense or int8 cache
    per tensor shard, on that shard's device, holding its own KV heads
    (`cfg.kv_heads / tp`); `length` is the cache's, as a host int or a 0-d
    device tensor on the lead device, and each shard reads it from here."""

    shards: tuple
    length: Any

    @property
    def k(self) -> torch.Tensor:
        return self.shards[0].k


def init_tp_cache(params: Params, cfg: GPTConfig, batch: int, max_len: int,
                  dtype: torch.dtype) -> TPCache:
    """A `TPCache` for the TP-placed `params`: each shard's on its device
    (data row 0's tensor entries, where the LM serves)."""
    mesh = mesh_of(params)
    lcfg = _shard_cfg(cfg, mesh.shape["tensor"])
    return TPCache(tuple(init_cache(lcfg, batch, max_len, dtype, mesh.device_list[i])
                         for i in _tensor_entries(mesh, 0)), 0)


def new_cache(params: Params, cfg: GPTConfig, batch: int, max_len: int, dtype: torch.dtype,
              device=None):
    """A fresh cache for `params`: a `TPCache` for a TP-placed tree, else
    `init_cache` on `device`."""
    if mesh_of(params) is not None:
        return init_tp_cache(params, cfg, batch, max_len, dtype)
    return init_cache(cfg, batch, max_len, dtype, device)


def cache_tensors(cache) -> list:
    """Every tensor field of a dense, int8 or TP cache, shard by shard."""
    if isinstance(cache, TPCache):
        return [t for c in cache.shards for t in cache_tensors(c)]
    return [t for t in cache if isinstance(t, torch.Tensor)]


def clone_cache(cache):
    """A copy of a dense, int8 or TP cache (its `length` kept)."""
    if isinstance(cache, TPCache):
        return cache._replace(shards=tuple(clone_cache(c) for c in cache.shards))
    return type(cache)(*(t.clone() if isinstance(t, torch.Tensor) else t for t in cache))


def cache_bytes(cache) -> int:
    """At-rest bytes of one cache (slabs and scale planes)."""
    return sum(quant.tensor_bytes(t) for t in cache_tensors(cache))


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------


def _ln(x, p, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return (((xf - mean) * torch.rsqrt(var + eps)) * p["scale"] + p["bias"]).to(x.dtype)


def _rmsnorm(x, p, eps):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * p["scale"]).to(x.dtype)


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) [B, S, 1, D/2] in float32 for RoPE at `positions` [B, S];
    computed once per forward and shared by every layer's q and k."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, half-split; x [B, S, H, D]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm(cfg: GPTConfig):
    """The arch's norm: LayerNorm for GPT-2, RMSNorm for llama."""
    return _ln if cfg.arch == "gpt2" else _rmsnorm


def _biased(out, p):
    """`out` plus the projection `p`'s bias, where it has one."""
    return out + p["bias"] if "bias" in p else out


def _proj(x, p):
    return _biased(quant.mm(x, p["kernel"]), p)


def _qkv(layer: Params, x: torch.Tensor, cfg: GPTConfig, rope):
    """q [B, S, nh, hd], k and v [B, S, nkv, hd] of x [B, S, H]: three
    projections, not a fused one, as in the JAX package; RoPE at `rope`
    (`_rope_angles`) where it is given."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q = _proj(x, layer["q"]).view(B, S, nh, hd)
    k = _proj(x, layer["k"]).view(B, S, nkv, hd)
    v = _proj(x, layer["v"]).view(B, S, nkv, hd)
    if rope is not None:
        q, k = _rope(q, *rope), _rope(k, *rope)
    return q, k, v


def qkv_proj(layer: Params, h: torch.Tensor, positions: torch.Tensor, cfg: GPTConfig):
    """QKV projection + RoPE at `positions` [B, S], no cache: the shared
    front half of attention for the training-side forwards
    (`parallel/context.py`, `parallel/pipeline.py`) → (q [B, S, nh, hd],
    k [B, S, nkv, hd], v [B, S, nkv, hd])."""
    rope = (_rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.arch == "llama" else None)
    return _qkv(layer, h, cfg, rope)


def _mlp(mlp: Params, h: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The MLP of h through its output projection's kernel (the bias is
    the caller's, once a TP layer's partial products are summed)."""
    if cfg.arch == "gpt2":
        a = F.gelu(_proj(h, mlp["in"]), approximate="tanh")  # GPT-2's gelu_new
        return quant.mm(a, mlp["out"]["kernel"])
    a = F.silu(quant.mm(h, mlp["gate"]["kernel"])) * quant.mm(h, mlp["up"]["kernel"])
    return quant.mm(a, mlp["down"]["kernel"])


def _mlp_out(mlp: Params, cfg: GPTConfig) -> Params:
    """The MLP's output projection (its bias, for GPT-2)."""
    return mlp["out" if cfg.arch == "gpt2" else "down"]


def block_nocache(layer: Params, x, cfg: GPTConfig, attn, mlp=None):
    """Decoder-block scaffolding (norms, residuals, MLP) with a pluggable
    attention callable `attn(normed hidden) -> attention output incl. the
    o-projection and its bias`; `mlp(normed hidden)` the MLP with its bias
    (this layer's own by default). The one home of the per-arch block
    math: `_block` plugs in its cache-threading attention and the tensor
    shards' sums, the pipeline stages (`parallel/pipeline.py`) their
    attention.

    A sequence-parallel block (`parallel/context.py`) passes `x` as the
    list of one sequence's blocks and `layer` as the list of the trees each
    block reads: `attn` then maps the list of normed blocks to the list of
    their outputs (the one step that mixes blocks), and the rest runs
    block by block."""
    if not isinstance(x, list):
        return block_nocache([layer], [x], cfg, lambda hs: [attn(hs[0])], mlp)[0]
    norm, eps = _norm(cfg), cfg.layer_norm_eps
    outs = attn([norm(xi, li["ln1"], eps) for xi, li in zip(x, layer)])
    out = []
    for xi, li, a in zip(x, layer, outs, strict=True):
        xi = xi + a
        h = norm(xi, li["ln2"], eps)
        out.append(xi + (mlp(h) if mlp is not None
                         else _biased(_mlp(li["mlp"], h, cfg), _mlp_out(li["mlp"], cfg))))
    return out


def _flash_prefill(cfg: GPTConfig, S: int, cache) -> bool:
    """Whether a forward of S tokens takes the flash kernel: a prefill of
    S > 1 tokens against an empty cache. The kernel attends over the S
    fresh tokens only, so a forward over a filled cache (a verify or
    tracking window) reads the cache instead."""
    return (cfg.attn_impl == "flash" and S > 1
            and (cache is None or (not isinstance(cache.length, torch.Tensor)
                                   and cache.length == 0)))


def _paged_write_read(cache: PagedKVCache, layer_idx: int, k, v, start, T: int, dtype):
    """The paged layout's half of `_attn`: scatter the S fresh K/V rows
    through the page table into the pool, in place (int8 codes and scales
    with `kv_quant="int8"`, at the same flat indices), then gather each
    row's whole [0, T) back into the dense layout's [B, T, kv_heads,
    head_dim], element for element. `start` is a host int or a 0-d device
    tensor: the write indices come from it and the read indices from the
    static T, both on the device, so a decode chunk over the page table
    has no host value in it. Slots on the scratch page are garbage, and
    always masked."""
    page = cache.page_tokens
    pt = cache.page_table
    S = k.shape[1]
    flat_w = _paged.flat_slot_index(pt, start + torch.arange(S, device=pt.device), page)
    flat_r = _paged.flat_slot_index(pt, torch.arange(T, device=pt.device), page)

    def write(pool, vals):  # pool[layer] as [n_pages·page, ...], a view
        pool[layer_idx].flatten(0, 1)[flat_w] = vals.to(pool.dtype)

    def read(pool):
        return pool[layer_idx].flatten(0, 1)[flat_r]

    if cache.quantized:
        (k_q, k_s), (v_q, v_s) = quant.kv_channel_quantize(k), quant.kv_channel_quantize(v)
        for pool, vals in ((cache.k, k_q), (cache.v, v_q), (cache.k_scale, k_s),
                           (cache.v_scale, v_s)):
            write(pool, vals)
        return (quant.kv_dequantize(read(cache.k), read(cache.k_scale), dtype),
                quant.kv_dequantize(read(cache.v), read(cache.v_scale), dtype))
    write(cache.k, k)
    write(cache.v, v)
    return read(cache.k).to(dtype), read(cache.v).to(dtype)


def _attn(layer: Params, x: torch.Tensor, layer_idx: int, cache, cfg: GPTConfig,
          rope, kv_valid: Optional[torch.Tensor], valid: Optional[torch.Tensor]):
    """x [B, S, H] → attention output through the o-projection's kernel
    (its bias is `_block`'s to add, once a TP layer's partial products are
    summed). Writes the S new K/V rows into the cache at [length,
    length + S); with no cache (a training forward) it writes nothing and
    attends over the S fresh tokens. `valid` is the [B|1, 1, 1, S, T] mask
    of visible cache slots (None on the flash prefill, which builds its
    own). Under TP, `layer` and `cfg` are one tensor shard's (`_shard_cfg`):
    its heads."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = _qkv(layer, x, cfg, rope)

    start = 0 if cache is None else cache.length
    # a device slot index writes through index_copy_ (no host value); a
    # host int through a slice
    rows = (start + torch.arange(S, device=x.device) if isinstance(start, torch.Tensor)
            else slice(start, start + S))

    def put(slab, vals):
        if isinstance(rows, slice):
            slab[layer_idx, :, rows] = vals
        else:
            slab[layer_idx].index_copy_(1, rows, vals.to(slab.dtype))

    if cache is None:
        k_all, v_all = k, v
    elif isinstance(cache, PagedKVCache):
        # a row's slot count is kv_valid's width (the pool has no T axis)
        k_all, v_all = _paged_write_read(cache, layer_idx, k, v, start, kv_valid.shape[1],
                                         x.dtype)
    elif isinstance(cache, QuantKVCache):
        k_q, k_s = quant.kv_channel_quantize(k)
        v_q, v_s = quant.kv_channel_quantize(v)
        put(cache.k, k_q)
        put(cache.v, v_q)
        put(cache.k_scale, k_s)
        put(cache.v_scale, v_s)
    else:
        put(cache.k, k)
        put(cache.v, v)

    if _flash_prefill(cfg, S, cache):
        # prefill from empty: the kernel attends over exactly the S fresh
        # tokens, [B, heads, S, D] contiguous, GQA by kv-head index
        bias = None
        if kv_valid is not None:
            bias = torch.where(kv_valid[:, :S], 0.0, MASK_NEG).float().contiguous()
        ctx = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), kv_bias=bias, causal=True)
        ctx = ctx.transpose(1, 2).reshape(B, S, nh * hd)
        return quant.mm(ctx, layer["o"]["kernel"])

    if isinstance(cache, QuantKVCache):
        k_all = quant.kv_dequantize(cache.k[layer_idx], cache.k_scale[layer_idx], x.dtype)
        v_all = quant.kv_dequantize(cache.v[layer_idx], cache.v_scale[layer_idx], x.dtype)
    elif isinstance(cache, KVCache):
        k_all, v_all = cache.k[layer_idx].to(x.dtype), cache.v[layer_idx].to(x.dtype)
    # GQA without repeat: query heads grouped onto their kv head
    q5 = q.view(B, S, nkv, nh // nkv, hd)
    scores = torch.einsum("bsngd,btnd->bngst", q5, k_all) / math.sqrt(hd)
    if x.dtype == torch.bfloat16:
        # the softmax stays bf16, as in the JAX package's bf16 mode
        probs = torch.softmax(scores.masked_fill(~valid, MASK_NEG), dim=-1)
    else:
        scores = torch.where(valid, scores.float(), MASK_NEG)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bngst,btnd->bsngd", probs, v_all).reshape(B, S, nh * hd)
    return quant.mm(ctx, layer["o"]["kernel"])


def _embed(tree: Params, ids: torch.Tensor, positions: torch.Tensor, cfg: GPTConfig,
           dtype: torch.dtype) -> torch.Tensor:
    """The token (and, for GPT-2, position) embeddings of ids [B, S] in
    `dtype` (quantized gathers dequantize to float32)."""
    x = quant.take(tree["wte"], ids)
    if cfg.arch == "gpt2":
        x = x + quant.take(tree["wpe"], positions)
    return x.to(dtype)


def _logits(tree: Params, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The final norm and the LM head of x [B, S, H] → float32 logits
    [B, S, V], for a tree that holds the whole vocab."""
    x = _norm(cfg)(x, tree["ln_f"], cfg.layer_norm_eps)
    if cfg.tie_word_embeddings:
        return quant.mm_tied(x, tree["wte"]).float()
    return quant.mm(x, tree["lm_head"]["kernel"]).float()


def _block(layers, x, layer_idx, caches, cfg, devs, ropes, kv_valids, valids, group=None):
    """One decoder layer on x [B, S, H]. `layers`, `devs` and the per-call
    lists hold one entry a tensor shard of this process (one for a plain
    tree): each shard runs the attention of its heads and the MLP of its
    width on its device, `cfg` being a shard's view (`_shard_cfg`), and the
    row-split projections' partial products (o, MLP out/down) are summed on
    x's device, and over `group` where the row's tensor shards span
    processes, before their bias, added once, from the first shard's tree.
    The norms, residuals and the MLP's math are `block_nocache`'s."""
    lead = x.device

    def attn(h):
        return _biased(sum_to([_attn(layer, h.to(dev), layer_idx, cache, cfg, rope, kv_valid,
                                     valid)
                               for layer, dev, cache, rope, kv_valid, valid
                               in zip(layers, devs, caches, ropes, kv_valids, valids)], lead,
                              group),
                       layers[0]["o"])

    def mlp(h):
        return _biased(sum_to([_mlp(layer["mlp"], h.to(dev), cfg)
                               for layer, dev in zip(layers, devs)], lead, group),
                       _mlp_out(layers[0]["mlp"], cfg))

    return block_nocache(layers[0], x, cfg, attn, mlp)


def _valid_mask(cfg: GPTConfig, S: int, cache, kv_valid, device):
    """The [B|1, 1, 1, S, T] mask of the cache slots each of S new tokens
    sees, or None on the flash prefill (which builds its own): causality
    over cache indices, where K/V live (they differ from logical positions
    on padded rows), padding slots via kv_valid."""
    if _flash_prefill(cfg, S, cache):
        return None
    if cache is None:
        T = S
    else:
        T = kv_valid.shape[1] if isinstance(cache, PagedKVCache) else cache.k.shape[2]
    kv_pos = torch.arange(T, device=device)
    length = 0 if cache is None else cache.length
    if isinstance(length, torch.Tensor):
        length = length.to(device)
    q_pos = length + torch.arange(S, device=device)
    valid = (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
    if kv_valid is not None:
        valid = valid & kv_valid.to(device)[:, None, None, None, :]
    return valid


# ---------------------------------------------------------------------------
# Tensor parallelism (megatron rules, `parallel/sharding.gpt_param_sharding`)
# ---------------------------------------------------------------------------


def _shard_cfg(cfg: GPTConfig, tp: int) -> GPTConfig:
    """One tensor shard's view of the model: its share of the heads, the KV
    heads and the MLP width (head_dim unchanged)."""
    return replace(cfg, hidden_size=cfg.hidden_size // tp, num_heads=cfg.num_heads // tp,
                   num_kv_heads=cfg.kv_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp)


def _tensor_entries(mesh, row: int) -> list:
    """The flat mesh entries of data row `row`'s tensor shards that this
    process holds, in order (all of them on a mesh of one process)."""
    return [i for i in (mesh.flat_index(data=row, tensor=t) for t in range(mesh.shape["tensor"]))
            if mesh.is_local(i)]


def _split_on_tensor(leaf, dim: int) -> bool:
    """Whether a placed leaf (a `QuantTensor`'s codes) splits dim `dim`
    over 'tensor'."""
    spec = (leaf.q if isinstance(leaf, quant.QuantTensor) else leaf).spec
    return -len(spec) <= dim < len(spec) and spec[dim] == "tensor"


def _shard_trees(params: Params, dtype: torch.dtype, device, row: int, home: bool):
    """(trees, devices, tensor indices, group) a forward runs on: a plain
    tree itself on `device`; a tree placed by `shard_params`, each tensor
    shard's plain tree of data row `row` that this process holds, on its
    device, the lead first, with its index on 'tensor' and the group of
    the row's tensor line where it spans processes (else None). Floating
    leaves in `dtype`, a `QuantTensor`'s float32 scales as they are
    (`quant.cast_params`).

    `home`: each block read from the local entry that first holds it,
    moved to where it is used (a train state's masters,
    `train/trainer.py`), so autograd sums every use's gradient into that
    one master; otherwise each entry reads its own shard."""
    mesh = mesh_of(params)
    if mesh is None:
        return [quant.cast_params(params, dtype)], [device], [0], None
    entries = _tensor_entries(mesh, row)
    devs = [mesh.device_list[i] for i in entries]

    def pick(x, t: int):
        if isinstance(x, quant.QuantTensor):
            return quant.QuantTensor(pick(x.q, t), pick(x.scale, t))
        return x.home(entries[t]).to(devs[t]) if home else x.shards[entries[t]]

    return ([quant.cast_params(quant.tree_map(lambda x: pick(x, t), params), dtype)
             for t in range(len(entries))], devs, [mesh.coords(i)["tensor"] for i in entries],
            mesh.group(("tensor",), entries[0]))


def forward(params: Params, input_ids: torch.Tensor, cache, positions: torch.Tensor,
            cfg: GPTConfig, kv_valid: Optional[torch.Tensor] = None,
            last_only: bool = False, row: int = 0, home: bool = False):
    """Forward over S new tokens against the cache → (logits float32
    [B, S, V], or [B, 1, V] with `last_only`, and the cache, written in
    place at [length, length + S); its `length` is the caller's to move).
    `cache=None` is the training forward (`train/trainer.lm_loss`): the S
    tokens attend causally over each other, as over a fresh cache, and no
    K/V is kept (JAX writes a cache there that XLA drops unread).

    `positions` [B, S] are the tokens' logical positions (RoPE / wpe);
    `kv_valid` [B, T] is False on padding slots, which attention never
    reads; the paged layout needs it (its width is a row's slot count).
    With `attn_impl == "flash"` a call of S > 1 tokens against an empty
    cache runs the kernel over the S fresh tokens; every other call reads
    the cache.

    Over params placed by `shard_params` (tensor parallelism) the forward
    runs on data row `row`'s tensor entries and answers on the first (the
    lead): each block's shards run their heads, KV heads (the cache is a
    `TPCache`) and MLP width on their devices (`_block`), and the residual
    stream, the norms and the replicated tables stay on the lead. A
    vocab-split `wte` is looked up per shard over its id range and the
    rows summed; a vocab-split head's logits are gathered. A flash prefill
    runs B1 per shard on its `[B, NH/tp, S, D]`. `home`: `_shard_trees`.

    Over a mesh that spans processes, each process runs the row's tensor
    entries it holds, answering on the first of them; the row-split sums,
    the vocab-split embedding's sum and the split head's gather (a sum of
    each shard's logits padded to the whole vocab) reach the row's other
    processes through its tensor line's group (`sharding.sum_to`). Only the
    cache-free training forward is ported there: a cache raises (ROADMAP
    A15 multi-host serving)."""
    if isinstance(cache, PagedKVCache) and kv_valid is None:
        raise ValueError("a forward over the paged KV layout needs kv_valid")
    dtype = torch_dtype(cfg.dtype)
    trees, devs, tcoords, group = _shard_trees(params, dtype, input_ids.device, row, home)
    tp, lead = axis_size(mesh_of(params), "tensor"), devs[0]
    vocab_split = tp > 1 and _split_on_tensor(params["wte"], 0)
    if tp > 1:
        if isinstance(cache, PagedKVCache):
            raise ValueError("the paged KV layout under a tensor-parallel mesh is not ported "
                             "(ROADMAP A15 stage 1b)")
        if cache is not None and group is not None:
            raise ValueError("a decode over a mesh that spans processes is not ported "
                             "(ROADMAP A15 multi-host serving)")
        caches = [None] * tp if cache is None else [
            c._replace(length=cache.length.to(d) if isinstance(cache.length, torch.Tensor)
                       else cache.length) for c, d in zip(cache.shards, devs)]
        shard_cfg = _shard_cfg(cfg, tp)
    else:
        caches, shard_cfg = [cache], cfg
    input_ids, positions = input_ids.to(lead), positions.to(lead)
    B, S = input_ids.shape
    if vocab_split:
        ids, vt = input_ids.clamp(0, cfg.vocab_size - 1), cfg.vocab_size // tp
        rows = []
        for t, tree, dev in zip(tcoords, trees, devs):
            loc = ids.to(dev) - t * vt
            rows.append(torch.where(((loc >= 0) & (loc < vt))[..., None],
                                    quant.take(tree["wte"], loc), 0.0))
        x = sum_to(rows, lead, group)
        if cfg.arch == "gpt2":
            x = x + quant.take(trees[0]["wpe"], positions)
        x = x.to(dtype)  # quantized gathers dequantize to float32
    else:
        x = _embed(trees[0], input_ids, positions, cfg, dtype)
    rope = (_rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.arch == "llama" else None)
    valid = _valid_mask(cfg, S, cache, kv_valid, lead)
    ropes = [None if rope is None else tuple(r.to(d) for r in rope) for d in devs]
    valids = [None if valid is None else valid.to(d) for d in devs]
    kv_valids = [None if kv_valid is None else kv_valid.to(d) for d in devs]
    for i in range(len(params["layers"])):
        x = _block([tree["layers"][i] for tree in trees], x, i, caches, shard_cfg, devs, ropes,
                   kv_valids, valids, group)
    if last_only:
        x = x[:, -1:]
    head_split = (vocab_split if cfg.tie_word_embeddings
                  else tp > 1 and _split_on_tensor(params["lm_head"]["kernel"], -1))
    if not head_split:
        return _logits(trees[0], x, cfg), cache
    # a split head: each shard's vocab slice of the logits, gathered on the lead
    x = _norm(cfg)(x, trees[0]["ln_f"], cfg.layer_norm_eps)
    parts = [quant.mm_tied(x.to(d), tree["wte"]) if cfg.tie_word_embeddings
             else quant.mm(x.to(d), tree["lm_head"]["kernel"]) for tree, d in zip(trees, devs)]
    if group is None:
        return torch.cat([p.to(lead) for p in parts], dim=-1).float(), cache
    V, vt = cfg.vocab_size, cfg.vocab_size // tp
    return sum_to([F.pad(p.to(lead), (t * vt, V - (t + 1) * vt)) for p, t in zip(parts, tcoords)],
                  lead, group).float(), cache


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def _top_k_bucket(top_k: int, vocab: int) -> int:
    """Power-of-two width of the top-k cutoff (the JAX package compiles one
    width per bucket; the exact k picks the threshold inside it). 0 = no
    cutoff (top_k <= 0, or >= vocab)."""
    if top_k <= 0 or top_k >= vocab:
        return 0
    b = 8
    while b < top_k:
        b *= 2
    return min(b, vocab)


def _norm_sampling(temperature, top_k, B: int, vocab: int, device=None):
    """Scalar-or-per-row sampling parameters → [B] tensors (float32
    temperatures, int64 top-k) and the top-k bucket wide enough for every
    row's cutoff."""
    t = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    k = np.broadcast_to(np.asarray(top_k, np.int64), (B,))
    cut = [int(x) for x in k if 0 < int(x) < vocab]
    bucket = _top_k_bucket(max(cut), vocab) if cut else 0
    return (torch.tensor(t, device=device), torch.tensor(k, device=device), bucket)


def _top_k_cut(scaled: torch.Tensor, top_k: torch.Tensor, top_k_bucket: int) -> torch.Tensor:
    """`scaled` [B, V] with -inf below each row's exact k-th largest value
    (rows with top_k <= 0 or >= V, or no bucket, untouched)."""
    if top_k_bucket == 0:
        return scaled
    vals = torch.topk(scaled, top_k_bucket, dim=-1).values  # descending
    kth = vals.gather(-1, (top_k.clamp(1, top_k_bucket) - 1)[:, None])
    cut = (top_k > 0) & (top_k < scaled.shape[-1])
    return scaled.masked_fill(cut[:, None] & (scaled < kth), -math.inf)


def _sample(logits: torch.Tensor, generator: torch.Generator, temperature: torch.Tensor,
            top_k: torch.Tensor, top_k_bucket: int) -> torch.Tensor:
    """Next tokens [B] from logits [B, V]. Per row: temperature <= 0 is
    greedy; top_k <= 0 (or >= V) disables the cutoff; otherwise the logits
    below the exact k-th largest are cut. Sampling is Gumbel-max: argmax of
    the scaled logits plus -log(-log u), u uniform from `generator`."""
    greedy = logits.argmax(dim=-1)
    scaled = _top_k_cut(logits / temperature.clamp_min(1e-6)[:, None], top_k, top_k_bucket)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _align_prompt(prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                  max_new_tokens: int):
    """Right-align prefix-aligned prompts → (ids_r, positions, kv_valid
    [B, P + max_new_tokens], prompt_len)."""
    B, P = prompt_ids.shape
    prompt_len = prompt_mask.long().sum(dim=1)
    pad = P - prompt_len  # left-pad width per row after alignment
    j = torch.arange(P, device=prompt_ids.device)[None, :]
    src = j - pad[:, None]
    ids_r = prompt_ids.gather(1, src.clamp(0, P - 1))
    ids_r = torch.where(src >= 0, ids_r, 0)
    positions = src.clamp_min(0)
    kv_valid = torch.cat([j >= pad[:, None],
                          torch.ones((B, max_new_tokens), dtype=torch.bool,
                                     device=prompt_ids.device)], dim=1)
    return ids_r, positions, kv_valid, prompt_len


def prefill(params, prompt_ids: torch.Tensor, prompt_mask: torch.Tensor, cfg: GPTConfig,
            max_new_tokens: int, cache=None):
    """Prompt forward against a fresh cache with room for `max_new_tokens`
    more → (cache, next_logits [B, V], kv_valid, prompt_len), the carry a
    decode loop resumes from. `cache`: a dense or int8 cache of that
    geometry to write into instead (length 0; slots past the prompt keep
    what they held, which no step reads before it writes them)."""
    B, P = prompt_ids.shape
    if cache is None:
        cache = new_cache(params, cfg, B, P + max_new_tokens, torch_dtype(cfg.dtype),
                          prompt_ids.device)
    elif cache.length != 0 or cache.k.shape[1:3] != (B, P + max_new_tokens):
        raise ValueError(f"prefill into a cache of {tuple(cache.k.shape)}, length "
                         f"{cache.length}: want [_, {B}, {P + max_new_tokens}, ...] at 0")
    ids_r, positions, kv_valid, prompt_len = _align_prompt(prompt_ids, prompt_mask,
                                                           max_new_tokens)
    logits, cache = forward(params, ids_r, cache, positions, cfg, kv_valid, last_only=True)
    return cache._replace(length=P), logits[:, -1], kv_valid, prompt_len


def _emit_one(tok, done, eos_id: int):
    """(token, counted, done) after one sampled token, as a decode step
    books it: a done row emits 0, an eos token is emitted but not counted
    and ends the row."""
    tok = torch.where(done, 0, tok)
    if eos_id >= 0:
        return tok, ~done & (tok != eos_id), done | (tok == eos_id)
    return tok, ~done, done


def _on_device_length(cache, device):
    """(the cache with a 0-d int64 device `length`, the host length it had
    or None): the spec rounds run at a device slot index, as `decode_chunk`
    does, so one captured round serves every slot."""
    if isinstance(cache.length, torch.Tensor):
        return cache, None
    return cache._replace(length=torch.full((), cache.length, dtype=torch.int64,
                                            device=device)), cache.length


def _caller_length(cache, host_length, advance: int):
    """The cache with `length` back in the caller's kind: the host length
    it came with plus `advance`, or the advanced device tensor."""
    return cache if host_length is None else cache._replace(length=host_length + advance)


def decode_chunk(params, cache, cur_logits, cur_pos, done, kv_valid,
                 generator: torch.Generator, steps: int, cfg: GPTConfig,
                 temperature=0.8, top_k=40, eos_id: int = -1, sampling=None):
    """`steps` decode steps from a carried state → (cache, logits, pos, done,
    tokens [B, steps], counted [B, steps]). Each step samples from the
    carried logits, masks rows already done (their token is 0), and runs
    the sampled tokens through the model at their positions.

    Every layout decodes at a device slot index: a host `length` becomes a
    0-d device tensor first, and the returned cache's `length` is the
    caller's kind again (int + steps, or the advanced tensor). The paged
    layout reads its page table on the device as it is; the host work of
    growing it happens before the chunk. `sampling`: the `_norm_sampling`
    triple, built outside the chunk, in place of temperature and top_k;
    with it the chunk makes no host value and no host sync, so it can be
    captured as a CUDA graph."""
    if sampling is None:
        sampling = _norm_sampling(temperature, top_k, cur_logits.shape[0], cfg.vocab_size,
                                  cur_logits.device)
    t, k, bucket = sampling
    cache, host_length = _on_device_length(cache, cur_logits.device)
    tokens, counted = [], []
    for _ in range(steps):
        tok, c, done = _emit_one(_sample(cur_logits, generator, t, k, bucket), done, eos_id)
        counted.append(c)
        tokens.append(tok)
        logits, cache = forward(params, tok[:, None], cache, cur_pos[:, None], cfg, kv_valid)
        cache = cache._replace(length=cache.length + 1)
        cur_logits, cur_pos = logits[:, 0], cur_pos + 1
    cache = _caller_length(cache, host_length, steps)
    return (cache, cur_logits, cur_pos, done, torch.stack(tokens, dim=1),
            torch.stack(counted, dim=1))


def _refuse_layout(cache, what: str, layouts=(KVCache, QuantKVCache)) -> None:
    if not isinstance(cache, layouts):
        raise ValueError(f"{what} splices rows of a {' or '.join(c.__name__ for c in layouts)}, "
                         f"not a {type(cache).__name__}")


def merge_cache_rows(cache_a, cache_b, row_map):
    """Row splice of two dense caches of one layout (the drafter's half of
    a splice): every tensor field of `cache_a` takes `cache_b`'s row
    row_map[i] at its row i (batch axis 1, the int8 cache's scale planes
    too) where row_map[i] >= 0; `length` keeps a's. The gap validity rides
    the shared kv_valid that `merge_rows` masks. In place on `cache_a`,
    which is returned. The JAX version donates cache_a to XLA to get the
    same effect; here the row copy is an `index_copy_`."""
    if isinstance(cache_a, TPCache):  # shard by shard
        for a, b in zip(cache_a.shards, cache_b.shards, strict=True):
            merge_cache_rows(a, b, row_map)
        return cache_a
    _refuse_layout(cache_a, "merge_cache_rows")
    dst, src = _paged.splice_rows(row_map, cache_b.k.shape[1], cache_a.k.device)
    if dst.numel():
        for fa, fb in zip(cache_a, cache_b):
            if isinstance(fa, torch.Tensor):
                fa.index_copy_(1, dst, fb.index_select(1, src))
    return cache_a


def merge_rows(cache_a, logits_a, pos_a, done_a, kv_valid_a,
               cache_b, logits_b, pos_b, done_b, kv_valid_b,
               row_map, prompt_width: int):
    """Continuous batching: splice freshly prefilled rows (state b) into a
    running chunked decode (state a) at a chunk boundary → (cache, logits,
    pos, done, kv_valid), state a's own tensors written in place.

    row_map [B] (host ints): row_map[i] = j >= 0 replaces a's row i with
    b's row j; -1 keeps a's row. Both states share the cache layout (the
    same prompt width and new-token bucket, so T matches). A spliced row's
    slots [prompt_width, a.length), the steps a decoded before the
    admission (the gap), are cleared in its kv_valid: the row's own decode
    writes at slot a.length onward while its logical position carries on
    from its prompt, so its output is exactly a standalone decode's.

    Three layouts splice here. Dense and int8 caches copy rows field by
    field. For the paged layout `cache_a` is a `PagedKVCache` and `cache_b`
    the triple `(staging, scatter_table, new_page_table)`: the dense-staged
    prefill (None when every admitted row was a full radix hit), the
    [bb, prompt_width / page] table of each staging row's fresh prompt
    blocks (scratch elsewhere), and the session's rebuilt page table; the
    cache half then happens in the pool (`kv/paged.scatter_prompt`) and the
    row-state half is `kv/paged.merge_row_state`.

    The JAX package builds new arrays and donates cache_a (its pools, for
    the paged layout); here the caches are written in place and `length`
    is a host int at a splice, so nothing needs donating. The paged
    layout's `new_page_table` is the session's device table, written in
    place before the splice, so a captured chunk reads the splice."""
    if not isinstance(cache_a, TPCache):  # a TP cache splices shard by shard
        _refuse_layout(cache_a, "merge_rows", (KVCache, QuantKVCache, PagedKVCache))
    if isinstance(cache_a, PagedKVCache):
        staging, scatter_table, new_page_table = cache_b
        if staging is not None:
            _paged.scatter_prompt(cache_a.k, cache_a.v, cache_a.k_scale, cache_a.v_scale,
                                  staging, scatter_table, prompt_width)
        state = _paged.merge_row_state(logits_a, pos_a, done_a, kv_valid_a, logits_b, pos_b,
                                       done_b, kv_valid_b, row_map, cache_a.length, prompt_width)
        return (cache_a._replace(page_table=new_page_table), *state)
    merge_cache_rows(cache_a, cache_b, row_map)
    state = _paged.merge_row_state(logits_a, pos_a, done_a, kv_valid_a, logits_b, pos_b, done_b,
                                   kv_valid_b, row_map, cache_a.length, prompt_width)
    return (cache_a, *state)


# ---------------------------------------------------------------------------
# Speculative decoding: draft k greedy tokens on a small model's own dense
# cache, score all k+1 positions with ONE target forward, emit the longest
# accepted prefix and the target's correction.
#
# The spec state (beside the plain state decode_chunk carries): the cache
# holds every emitted token but the last, which rides as `pending` [B], and
# `cur_pos` is pending's logical position. Each round writes the S = k+1
# window [pending, d_1..d_k] into both caches (the drafter's k steps plus
# one more forward of d_k, the target's verify forward), so the two share
# one kv_valid / cur_pos / done and advance `length` by S a round. Slot j of
# a row's window stays valid iff j <= the row's accepted count; rejected
# slots become holes that kv_valid masks, as it masks left padding.
# ---------------------------------------------------------------------------


def spec_first(cur_logits, done, generator: torch.Generator, cfg: GPTConfig,
               temperature=0.8, top_k=40, eos_id: int = -1, sampling=None):
    """plain → spec: sample one token from the carried logits (exactly what
    the next plain step would emit) without forwarding it; it becomes
    `pending`. Returns (tok, counted, done). `sampling`: the
    `_norm_sampling` triple built outside, in place of temperature and
    top_k (no host value inside, as `decode_chunk`)."""
    if sampling is None:
        sampling = _norm_sampling(temperature, top_k, cur_logits.shape[0], cfg.vocab_size,
                                  cur_logits.device)
    t, k, bucket = sampling
    return _emit_one(_sample(cur_logits, generator, t, k, bucket), done, eos_id)


def draft_chunk(draft_params, d_cache, pending, cur_pos, done, kv_valid,
                dcfg: GPTConfig, spec_k: int):
    """The drafter's round: `spec_k` greedy steps from `pending` on its own
    dense cache, then d_k forwarded once more (logits dropped) so the
    drafter writes the same k+1 window slots the target's verify writes.
    Greedy drafts make the proposal a point mass, so a sampled row's
    acceptance in `verify_chunk` is one coin flip on p_target(draft).
    Returns (cache, drafts [B, k]); the cache's `length` is advanced by
    k + 1 in the caller's kind (the round itself runs at a device slot)."""
    d_cache, host_length = _on_device_length(d_cache, pending.device)
    tok, pos, drafts = pending, cur_pos, []
    for _ in range(spec_k):
        tok = torch.where(done, 0, tok)
        logits, d_cache = forward(draft_params, tok[:, None], d_cache, pos[:, None], dcfg,
                                  kv_valid)
        d_cache = d_cache._replace(length=d_cache.length + 1)
        tok, pos = logits[:, 0].argmax(dim=-1), pos + 1
        drafts.append(tok)
    _, d_cache = forward(draft_params, torch.where(done, 0, tok)[:, None], d_cache,
                         pos[:, None], dcfg, kv_valid)
    d_cache = d_cache._replace(length=d_cache.length + 1)
    return _caller_length(d_cache, host_length, spec_k + 1), torch.stack(drafts, dim=1)


def verify_chunk(params, cache, pending, drafts, cur_pos, done, kv_valid,
                 generator: torch.Generator, cfg: GPTConfig, temperature=0.8, top_k=40,
                 eos_id: int = -1, sampling=None):
    """Score k drafts and emit in ONE target forward → (cache, pending,
    cur_pos, done, kv_valid, out [B, k+1], counted [B, k+1], emitted [B]);
    a row's tokens are out[i, :emitted[i]] filtered through counted.

    Greedy rows accept the longest prefix equal to the target's argmax,
    token-identical to plain decode; sampled rows accept a draft when
    u < p_target(draft) under the transformed distribution `_sample` draws
    from, and draw their correction from it with the rejected token masked
    out (or, every draft accepted, the bonus position's). u and the
    correction's Gumbel noise come from `generator`, in that order.

    The round runs at a device slot index (a host `length` becomes one and
    comes back as the caller's kind) and writes the window's validity into
    the kv_valid it is given, in place, at slots `length + arange(k + 1)`
    (JAX's `dynamic_update_slice`, on the array it donates): rejected
    slots become holes. `sampling`: the `_norm_sampling` triple built
    outside; with it the round makes no host value and no host sync."""
    B, k = drafts.shape
    S = k + 1
    if sampling is None:
        sampling = _norm_sampling(temperature, top_k, B, cfg.vocab_size, drafts.device)
    t, tk, bucket = sampling
    cache, host_length = _on_device_length(cache, drafts.device)
    seq = torch.where(done[:, None], 0, torch.cat([pending[:, None], drafts], dim=1))
    jj = torch.arange(S, device=drafts.device)
    positions = cur_pos[:, None] + jj[None, :]
    # logits[:, j] is the next-token distribution after seq[:, :j+1]: slot
    # j scores d_{j+1}, slot k is the bonus position
    logits, cache = forward(params, seq, cache, positions, cfg, kv_valid)
    start = cache.length
    cache = _caller_length(cache._replace(length=start + S), host_length, S)

    greedy_row = t <= 0.0
    tgt = logits.argmax(dim=-1)  # [B, S]
    # the distribution `_sample` draws from, at every window position
    scaled = _top_k_cut((logits / t.clamp_min(1e-6)[:, None, None]).flatten(0, 1),
                        tk.repeat_interleave(S), bucket).view(B, S, -1)
    probs = torch.softmax(scaled, dim=-1)
    p_d = probs[:, :k].gather(-1, drafts[:, :, None])[..., 0]  # [B, k]
    u = torch.rand((B, k), generator=generator, device=drafts.device)
    acc = torch.where(greedy_row[:, None], drafts == tgt[:, :k], u < p_d)
    m = acc.long().cumprod(dim=1).sum(dim=1)  # [B], 0..k

    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    scaled_m = scaled.gather(1, m[:, None, None].expand(B, 1, scaled.shape[-1]))[:, 0]
    d_rej = drafts_pad.gather(1, m[:, None])[:, 0]
    vocab = torch.arange(scaled_m.shape[-1], device=drafts.device)
    rej = (vocab[None, :] == d_rej[:, None]) & ((~greedy_row) & (m < k))[:, None]
    scaled_m = scaled_m.masked_fill(rej, -math.inf)
    g = torch.rand(scaled_m.shape, generator=generator, device=drafts.device)
    sampled_c = (scaled_m - torch.log(-torch.log(g))).argmax(dim=-1)
    corr = torch.where(greedy_row, tgt.gather(1, m[:, None])[:, 0], sampled_c)

    # slots 0..m-1 the accepted drafts, slot m the correction; an eos token
    # is emitted but not counted, nothing after it counts, the row goes done
    jj = jj[None, :]
    out = torch.where(jj < m[:, None], drafts_pad, torch.where(jj == m[:, None], corr[:, None], 0))
    emit = (jj <= m[:, None]) & ~done[:, None]
    out = torch.where(emit, out, 0)
    if eos_id >= 0:
        hit = emit & (out == eos_id)
        before = hit.long().cumsum(dim=1) - hit.long()
        counted = emit & (before == 0) & (out != eos_id)
        new_done = done | hit.any(dim=1)
    else:
        counted, new_done = emit, done

    # rejected slots j > m become holes; a done row's window is junk kept
    # valid, as plain decode writes forced zeros for done rows
    m_adv = torch.where(done, k, m)
    kv_valid.index_copy_(1, start + jj[0], jj <= m_adv[:, None])
    new_pos = cur_pos + torch.where(done, S, m + 1)
    new_pending = torch.where(new_done, 0, corr)
    emitted = torch.where(done, 0, m + 1)
    return cache, new_pending, new_pos, new_done, kv_valid, out, counted, emitted


def ingest_pending(params, cache, pending, cur_pos, done, kv_valid, cfg: GPTConfig):
    """spec → plain: forward `pending` into the cache (one slot) → (cache,
    logits [B, V], cur_pos + 1), the logits a plain step at that position
    carries, so greedy output stays token-identical across the switch. At
    a device slot index, the cache's `length` back in the caller's kind."""
    cache, host_length = _on_device_length(cache, pending.device)
    logits, cache = forward(params, torch.where(done, 0, pending)[:, None], cache,
                            cur_pos[:, None], cfg, kv_valid)
    cache = _caller_length(cache._replace(length=cache.length + 1), host_length, 1)
    return cache, logits[:, 0], cur_pos + 1


def track_chunk(draft_params, d_cache, toks, start_pos, kv_valid, dcfg: GPTConfig):
    """The drafter's lockstep through a plain interlude: teacher-force the
    tokens a plain chunk just wrote into the target's cache (its `toks`,
    done rows' zeros included) into the drafter's cache at the same slots
    and positions, in one forward. Keeps the two caches slot-symmetric, so
    speculation can re-enter after the margin guard or a splice without a
    drafter prefill. At a device slot index, as the other rounds."""
    S = toks.shape[1]
    d_cache, host_length = _on_device_length(d_cache, toks.device)
    positions = start_pos[:, None] + torch.arange(S, device=toks.device)[None, :]
    _, d_cache = forward(draft_params, toks, d_cache, positions, dcfg, kv_valid)
    return _caller_length(d_cache._replace(length=d_cache.length + S), host_length, S)


def generate(params, prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
             generator: torch.Generator, cfg: GPTConfig, max_new_tokens: int = 64,
             temperature=0.8, top_k=40, eos_id: int = -1):
    """Prefill, then `max_new_tokens` decode steps → (tokens [B,
    max_new_tokens], lengths [B]). Prompts arrive prefix-aligned (real
    tokens first, `prompt_mask` 1 on them) and are right-aligned inside, so
    every row's last prompt token sits at cache index P - 1 and each row's
    output is independent of its batchmates. Rows stop at `eos_id` (if
    >= 0); `lengths` counts the tokens before it. `temperature` and `top_k`
    are scalars or per-row sequences."""
    B = prompt_ids.shape[0]
    cache, logits, kv_valid, prompt_len = prefill(params, prompt_ids, prompt_mask, cfg,
                                                  max_new_tokens)
    done = torch.zeros((B,), dtype=torch.bool, device=prompt_ids.device)
    *_, tokens, counted = decode_chunk(params, cache, logits, prompt_len, done, kv_valid,
                                       generator, max_new_tokens, cfg, temperature,
                                       top_k, eos_id)
    return tokens, counted.sum(dim=1)


# ---------------------------------------------------------------------------
# Init (random params; real weights via models/convert.py)
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: GPTConfig, device=None) -> Params:
    """Random params, normal(0, 0.02) kernels and tables, unit norm scales,
    zero biases, float32, drawn from `generator` on `device` (the
    generator's device)."""
    device = generator.device if device is None else torch.device(device)
    H, I, hd, nkv = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.kv_heads

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=device).mul_(0.02)

    def ones(n):
        return torch.ones((n,), device=device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def layer():
        if cfg.arch == "gpt2":
            return {
                "ln1": {"scale": ones(H), "bias": zeros(H)},
                "ln2": {"scale": ones(H), "bias": zeros(H)},
                "q": {"kernel": dense(H, H), "bias": zeros(H)},
                "k": {"kernel": dense(H, H), "bias": zeros(H)},
                "v": {"kernel": dense(H, H), "bias": zeros(H)},
                "o": {"kernel": dense(H, H), "bias": zeros(H)},
                "mlp": {"in": {"kernel": dense(H, I), "bias": zeros(I)},
                        "out": {"kernel": dense(I, H), "bias": zeros(H)}},
            }
        return {
            "ln1": {"scale": ones(H)},
            "ln2": {"scale": ones(H)},
            "q": {"kernel": dense(H, H)},
            "k": {"kernel": dense(H, nkv * hd)},
            "v": {"kernel": dense(H, nkv * hd)},
            "o": {"kernel": dense(H, H)},
            "mlp": {"gate": {"kernel": dense(H, I)}, "up": {"kernel": dense(H, I)},
                    "down": {"kernel": dense(I, H)}},
        }

    params: Params = {"wte": dense(cfg.vocab_size, H),
                      "layers": [layer() for _ in range(cfg.num_layers)]}
    if cfg.arch == "gpt2":
        params["wpe"] = dense(cfg.max_position_embeddings, H)
        params["ln_f"] = {"scale": ones(H), "bias": zeros(H)}
    else:
        params["ln_f"] = {"scale": ones(H)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, cfg.vocab_size)}
    return params
