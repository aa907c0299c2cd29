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
  S new tokens at cache indices `[length, length + S)`; `kv_quant="int8"`
  keeps int8 codes with one float32 scale per (position, kv head);
- GQA as a 5-D einsum that groups query heads on their kv head, no repeat;
  causality runs over cache indices, padding slots masked by `kv_valid`;
- `attn_impl="flash"`: a prefill (S > 1 against an empty cache) runs the
  CUDA flash-attention kernel (`ops/flash_attention.py`), causal, GQA
  inside, on CUDA tensors, and its plain version on CPU ones; decode steps
  (S == 1) read the cache with the plain path either way;
- sampling is Gumbel-max over an explicit `torch.Generator`: per-row
  temperature (greedy at ≤ 0) and an exact per-row top-k threshold inside a
  power-of-two bucket. Sampled tokens cannot match the JAX package's
  threefry draws; greedy ones do.

The decode loop runs every one of its steps and masks finished rows, as the
JAX `lax.scan` does, so it never waits on the device between steps.
`merge_rows` splices freshly prefilled rows into a running decode at a
chunk boundary (continuous batching), in place.

Not ported yet (ROADMAP Queue A): the paged cache branch (A12);
`spec_first`, `draft_chunk`, `verify_chunk`, `ingest_pending` and
`track_chunk` (A13); `qkv_proj` and `block_nocache` (A14, A15).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.ops.flash_attention import MASK_NEG, flash_attention

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
    head_dim]; `length` is the number of slots written, a host int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


class QuantKVCache(NamedTuple):
    """The int8 cache (`kv_quant="int8"`): int8 k/v slabs, one float32
    scale per (layer, batch, position, kv head); quantize-on-append,
    dequant-on-attend."""

    k: torch.Tensor        # int8 [L, B, T, kv_heads, head_dim]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [L, B, T, kv_heads]
    v_scale: torch.Tensor
    length: int


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


def cache_bytes(cache) -> int:
    """At-rest bytes of one cache (slabs and scale planes)."""
    return sum(quant.tensor_bytes(t) for t in cache if isinstance(t, torch.Tensor))


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


def _proj(x, p):
    out = quant.mm(x, p["kernel"])
    return out + p["bias"] if "bias" in p else out


def _attn(layer: Params, x: torch.Tensor, layer_idx: int, cache, cfg: GPTConfig,
          rope, kv_valid: Optional[torch.Tensor], valid: Optional[torch.Tensor]):
    """x [B, S, H] → attention output incl. the o-projection. Writes the S
    new K/V rows into the cache at [length, length + S). `valid` is the
    [B|1, 1, 1, S, T] mask of visible cache slots (None on the flash
    prefill, which builds its own)."""
    B, S, H = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    # three projections, not a fused one, as in the JAX package
    q = _proj(x, layer["q"]).view(B, S, nh, hd)
    k = _proj(x, layer["k"]).view(B, S, nkv, hd)
    v = _proj(x, layer["v"]).view(B, S, nkv, hd)
    if rope is not None:
        q, k = _rope(q, *rope), _rope(k, *rope)

    start = cache.length
    rows = slice(start, start + S)
    if isinstance(cache, QuantKVCache):
        k_q, k_s = quant.kv_channel_quantize(k)
        v_q, v_s = quant.kv_channel_quantize(v)
        cache.k[layer_idx, :, rows] = k_q
        cache.v[layer_idx, :, rows] = v_q
        cache.k_scale[layer_idx, :, rows] = k_s
        cache.v_scale[layer_idx, :, rows] = v_s
    else:
        cache.k[layer_idx, :, rows] = k
        cache.v[layer_idx, :, rows] = v

    if cfg.attn_impl == "flash" and S > 1:
        # prefill from empty: the kernel attends over exactly the S fresh
        # tokens, [B, heads, S, D] contiguous, GQA by kv-head index
        bias = None
        if kv_valid is not None:
            bias = torch.where(kv_valid[:, :S], 0.0, MASK_NEG).float().contiguous()
        ctx = flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), kv_bias=bias, causal=True)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        return _proj(ctx, layer["o"])

    if isinstance(cache, QuantKVCache):
        k_all = quant.kv_dequantize(cache.k[layer_idx], cache.k_scale[layer_idx], x.dtype)
        v_all = quant.kv_dequantize(cache.v[layer_idx], cache.v_scale[layer_idx], x.dtype)
    else:
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
    ctx = torch.einsum("bngst,btnd->bsngd", probs, v_all).reshape(B, S, H)
    return _proj(ctx, layer["o"])


def _block(layer, x, layer_idx, cache, cfg, rope, kv_valid, valid):
    if cfg.arch == "gpt2":
        x = x + _attn(layer, _ln(x, layer["ln1"], cfg.layer_norm_eps), layer_idx,
                      cache, cfg, rope, kv_valid, valid)
        h = _proj(_ln(x, layer["ln2"], cfg.layer_norm_eps), layer["mlp"]["in"])
        h = F.gelu(h, approximate="tanh")  # GPT-2's gelu_new
        return x + _proj(h, layer["mlp"]["out"])
    x = x + _attn(layer, _rmsnorm(x, layer["ln1"], cfg.layer_norm_eps), layer_idx,
                  cache, cfg, rope, kv_valid, valid)
    h = _rmsnorm(x, layer["ln2"], cfg.layer_norm_eps)
    gate = F.silu(quant.mm(h, layer["mlp"]["gate"]["kernel"]))
    up = quant.mm(h, layer["mlp"]["up"]["kernel"])
    return x + quant.mm(gate * up, layer["mlp"]["down"]["kernel"])


def forward(params: Params, input_ids: torch.Tensor, cache, positions: torch.Tensor,
            cfg: GPTConfig, kv_valid: Optional[torch.Tensor] = None,
            last_only: bool = False):
    """Forward over S new tokens against the cache → (logits float32
    [B, S, V], or [B, 1, V] with `last_only`, and the cache, written in
    place at [length, length + S); its `length` is the caller's to move).

    `positions` [B, S] are the tokens' logical positions (RoPE / wpe);
    `kv_valid` [B, T] is False on padding slots, which attention never
    reads. With `attn_impl == "flash"` any S > 1 call must be a prefill
    against an empty cache (length 0): the kernel attends over exactly the
    S fresh tokens."""
    dtype = torch_dtype(cfg.dtype)
    # floating leaves → compute dtype (a no-op on leaves already in it);
    # QuantTensor leaves keep their float32 scales
    params = quant.cast_params(params, dtype)
    B, S = input_ids.shape
    x = quant.take(params["wte"], input_ids)
    if cfg.arch == "gpt2":
        x = x + quant.take(params["wpe"], positions)
    x = x.to(dtype)  # quantized gathers dequantize to float32
    rope = (_rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.arch == "llama" else None)
    valid = None
    if not (cfg.attn_impl == "flash" and S > 1):
        # causality over cache indices, where K/V live (they differ from
        # logical positions on padded rows); padding slots via kv_valid
        T = cache.k.shape[2]
        kv_pos = torch.arange(T, device=input_ids.device)
        q_pos = cache.length + torch.arange(S, device=input_ids.device)
        valid = (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
        if kv_valid is not None:
            valid = valid & kv_valid[:, None, None, None, :]
    for i, layer in enumerate(params["layers"]):
        x = _block(layer, x, i, cache, cfg, rope, kv_valid, valid)
    if last_only:
        x = x[:, -1:]
    if cfg.arch == "gpt2":
        x = _ln(x, params["ln_f"], cfg.layer_norm_eps)
    else:
        x = _rmsnorm(x, params["ln_f"], cfg.layer_norm_eps)
    if cfg.tie_word_embeddings:
        logits = quant.mm_tied(x, params["wte"])
    else:
        logits = quant.mm(x, params["lm_head"]["kernel"])
    return logits.float(), cache


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
            max_new_tokens: int):
    """Prompt forward against a fresh cache with room for `max_new_tokens`
    more → (cache, next_logits [B, V], kv_valid, prompt_len), the carry a
    decode loop resumes from."""
    B, P = prompt_ids.shape
    cache = init_cache(cfg, B, P + max_new_tokens, torch_dtype(cfg.dtype),
                       prompt_ids.device)
    ids_r, positions, kv_valid, prompt_len = _align_prompt(prompt_ids, prompt_mask,
                                                           max_new_tokens)
    logits, cache = forward(params, ids_r, cache, positions, cfg, kv_valid, last_only=True)
    return cache._replace(length=P), logits[:, -1], kv_valid, prompt_len


def decode_chunk(params, cache, cur_logits, cur_pos, done, kv_valid,
                 generator: torch.Generator, steps: int, cfg: GPTConfig,
                 temperature=0.8, top_k=40, eos_id: int = -1):
    """`steps` decode steps from a carried state → (cache, logits, pos, done,
    tokens [B, steps], counted [B, steps]). Each step samples from the
    carried logits, masks rows already done (their token is 0), and runs
    the sampled tokens through the model at their positions."""
    t, k, bucket = _norm_sampling(temperature, top_k, cur_logits.shape[0],
                                  cfg.vocab_size, cur_logits.device)
    tokens, counted = [], []
    for _ in range(steps):
        tok = _sample(cur_logits, generator, t, k, bucket)
        tok = torch.where(done, 0, tok)
        if eos_id >= 0:
            counted.append(~done & (tok != eos_id))
            done = done | (tok == eos_id)
        else:
            counted.append(~done)
        tokens.append(tok)
        logits, cache = forward(params, tok[:, None], cache, cur_pos[:, None], cfg, kv_valid)
        cache = cache._replace(length=cache.length + 1)
        cur_logits, cur_pos = logits[:, 0], cur_pos + 1
    return (cache, cur_logits, cur_pos, done, torch.stack(tokens, dim=1),
            torch.stack(counted, dim=1))


def _splice_rows(row_map, n_b: int, device):
    """Host `row_map` [B] → (destination rows, source rows) as int64
    tensors on `device`: row i takes b's row row_map[i] where that is
    >= 0."""
    rm = np.asarray(row_map.cpu() if isinstance(row_map, torch.Tensor) else row_map,
                    np.int64)
    dst = np.nonzero(rm >= 0)[0]
    if dst.size and int(rm[dst].max()) >= n_b:
        raise ValueError(f"row_map {rm.tolist()} names a row past the {n_b} prepared ones")
    return (torch.from_numpy(dst).to(device), torch.from_numpy(rm[dst]).to(device))


def _refuse_paged(cache) -> None:
    if not isinstance(cache, (KVCache, QuantKVCache)):
        raise ValueError(f"cannot splice rows of a {type(cache).__name__}: the paged KV "
                         "layout is not ported (ROADMAP A12: paged KV)")


def merge_cache_rows(cache_a, cache_b, row_map):
    """Row splice of two caches of one layout: every tensor field of
    `cache_a` takes `cache_b`'s row row_map[i] at its row i (batch axis 1,
    the int8 cache's scale planes too) where row_map[i] >= 0; `length`
    keeps a's. In place on `cache_a`, which is returned. The JAX version
    donates cache_a to XLA to get the same effect; here the row copy is an
    `index_copy_`."""
    _refuse_paged(cache_a)
    dst, src = _splice_rows(row_map, cache_b.k.shape[1], cache_a.k.device)
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

    The JAX package's `_merge_rows_jit` builds new arrays and donates
    cache_a; here the cache is already written in place and its `length`
    is a host int, so the splice is an in-place row copy and needs no
    donation. The paged layout's branch waits for ROADMAP A12 and raises."""
    _refuse_paged(cache_a)
    T = cache_a.k.shape[2]
    t_idx = torch.arange(T, device=kv_valid_b.device)
    gap = (t_idx >= prompt_width) & (t_idx < cache_a.length)
    kv_b = kv_valid_b & ~gap[None, :]
    merge_cache_rows(cache_a, cache_b, row_map)
    dst, src = _splice_rows(row_map, logits_b.shape[0], logits_a.device)
    if dst.numel():
        for a, b in ((logits_a, logits_b), (pos_a, pos_b), (done_a, done_b),
                     (kv_valid_a, kv_b)):
            a.index_copy_(0, dst, b.index_select(0, src))
    return cache_a, logits_a, pos_a, done_a, kv_valid_a


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
