"""LmEngine — autoregressive text generation on one CUDA device.

The port of `symbiont_tpu/engine/lm.py` (BASELINE.md config #5, GPT-2 and
TinyLlama-1.1B generation), with its public surface for one-shot
generation (`generate`, `generate_batch`, `update_params`, `warmup`,
`model_cfg`, `tokenizer`, `stats`) and its semantics:

- `model_dir`: a local GPT-2 or Llama checkpoint through
  `models/convert.py`, with its tokenizer.json when there is one, else the
  byte tokenizer; synthetic mode (no `model_dir`): a byte-level model of
  the configured width with random weights;
- prompts are tail-trimmed to the largest usable prompt bucket (a bucket
  plus the new-token bucket must fit the model's positions), empty ones
  take BOS, and the batch is row-padded to a power of two, so the shapes the
  device sees stay |prompt buckets| × |new-token buckets| × log2(batch);
- parameters are cast to the compute dtype first and quantized second
  (`quantize` none/f16/int8/fp8), leaf by leaf on the device, so f16's
  bf16 matrices stay bf16 whatever the compute dtype;
- `attn_impl` "auto" resolves to the plain torch attention ("xla");
  "flash" runs the prefill through the CUDA flash-attention kernel;
- sampling draws from the engine's one `torch.Generator`, seeded from
  `LmConfig.seed`; padding rows decode greedily and are dropped.

Streaming and continuous batching, as in JAX: `generate_stream` yields
text deltas per chunk of `stream_chunk` decode steps (one prefill, then
`gpt.decode_chunk` on the carried state); `start_session` opens a
`BatchSession` that decodes in chunks and splices newly prefilled rows
into free batch rows at chunk boundaries (`prepare_admit` prefills off the
engine lock, `splice` merges under it), with `can_admit` gating on a row
cap and a forecast of the fresh device bytes; `engine/batcher.py`'s
`GenBatcher` drives sessions for concurrent requests. Each stream and each
session samples from a `torch.Generator` of its own, seeded by one draw
from the engine's seed sequence under the lock, so its tokens do not depend
on what other callers interleave. The sequence is a numpy generator on the
host, so a draw waits on no device work. A stream draws each chunk (or
speculative round) from a generator seeded by its base seed and the chunk's
index, so a journal that records the two restores the draws at any chunk
boundary.

Paged KV and speculative decoding, as in JAX: with `kv_layout="paged"`
sessions keep their K/V in one engine-wide page pool (`kv/pool.py`), pages
growing as rows decode and returning the moment a row finishes, and with
`kv_radix` a prefix cache (`kv/radix.py`) shares committed prompt pages
between admissions, a full hit skipping its prefill; streams and
`generate_batch` stay dense. With a drafter (`draft_params` and
`draft_model_cfg`, or `spec_draft_model`, a checkpoint dir checked by
`config.validate_spec_draft`), streams and sessions run draft + verify
rounds of `spec_k` tokens while the slot margin allows, degrading to plain
decode (never an error) on a missing drafter dir, a failed draft prefill,
a pool exhausted in a spec window, or an acceptance EMA near 0.

Observability, as the JAX engine records it: `lm.param_bytes{dtype}`, the
`lm.params`, `lm.kv_cache` (dense) and `lm.drafter` claims in the
device-memory ledger (the pool claims itself), the session KV gauges
(`lm.kv_rows_active`, `lm.kv_rows_allocated`, `lm.kv_stranded_rows`,
`lm.kv_cache_bytes`, `lm.kv_rows_per_gib`), the pool's `kv.*` gauges and
`kv.page_fragmentation_pct`, `lm.spec_accept_rate`,
`lm.decode_tok_per_s`, `lm.hbm_headroom_bytes`, the `lm.ttft_ms` and
`lm.tpot_ms` histograms, the engine timeline's decode events, per-tenant
usage, dispatch-ledger rows per prefill, chunk, round and splice, and
`maybe_profile("engine.generate")` around each batch.

Durable generation, as in JAX: with a `journal` (resilience/genlog.py)
attached, every stream with a `task_id` and every session row with one
appends a resume snapshot at each chunk boundary, from host values already
in hand; `generate_stream(resume=tail)` re-prefills the journalled prompt +
generated prefix (the prefill a cold stream runs, B1 under "flash") and
continues it, replaying the last journalled chunk at its original `seq`.
The journal's `key` of a sampled stream is `[base seed]` and `key_splits`
the chunks it consumed: a sampled tail resumes only on this package's
engine (a JAX tail's threefry key is refused), a greedy one (`key: null`)
on either.

Decode executables, as JAX's `_decode_chunk_jit` (A16 stages 2-3): a
decode chunk writes its K/V at a device slot index (`gpt.decode_chunk`),
so on CUDA a chunk of `stream_chunk` steps is a graph captured on its
carry (the cache, logits, pos, done and kv_valid it reads and writes in
place, what the JAX executable donates) and replayed for every later
chunk (`_CarryDecoder`). Carriers are lent out of an engine-owned pool by
geometry (KV layout, rows, prompt bucket, new bucket): `generate_batch`,
a stream and a session take the borrowed carrier's cache (dense) or page
table (paged), sample from its generator (seeded by one draw from the
engine's, or per chunk from a stream's base seed) and give it back at
their end (a session when its owner closes it), so every caller of a
geometry replays the graph its first one captured, as JAX reuses its
executable per shape. The pool keeps one free carrier a geometry, within
the bytes of one session at the largest geometry the configuration
admits. The carry that `merge_rows` splices in place stays bound; a
shorter last chunk runs eagerly. The generator is registered with the
graph, so a replay draws what the eager chunk would.

Spec round executables, as JAX's `_spec_first_jit`, `_draft_chunk_jit`,
`_verify_chunk_jit`, `_ingest_pending_jit` and `_track_chunk_jit` (A16
stage 4): the same carrier holds the drafter's dense cache (a spec
borrower's drafter prefill lands in it) and `pending`, and each round
function runs at a device slot index with its sampling triple built
outside, so on CUDA the draft (spec_k drafter steps and the extra
forward), the verify, `spec_first`, the ingest and a track per window
width are graphs captured at their first call and replayed after, one per
shape. Draft and verify stay two replays, timed by CUDA events around
them; the round keeps its one device → host fetch.

Prefill executables, as JAX's `prefill` jitted per (B, P, max_new): one
executable per (model, kv_quant, rows, prompt bucket, new bucket)
(`_prefill`), its static inputs the prompt ids and mask, its outputs the
logits, `kv_valid` and `prompt_len`, writing a cache of its own in place.
Every prefill replays it: a carrier's borrower takes the prompt slots
copied into the carrier's cache, an admission or a drafter a clone, a
paged session the scatter into its pages. These graphs keep a pool and a
replay lock of their own (`_stage_lock`), so an admission prefill replays
beside a decoding `step()` without the engine lock. A model's executables
are bounded by their caches' bytes, the cache of one session at the
largest geometry the configuration admits, least recently used first out
(`_trim_prefills`). On the CPU the same executables run eagerly. `update_params` (the
online fine-tune's sync, `train/online.py`) copies the new weights into
the tensors every executable reads, so a sync captures nothing again.

Tensor-parallel decode, as in JAX (A15 stage 1): a `mesh` whose 'tensor'
axis is > 1 shards the parameters on the megatron rules
(`parallel/sharding.py`, quantized leaves with their scales) and every
prefill, chunk and splice runs `gpt.forward` over the tensor entries of
the mesh's first data row, each shard's KV heads in its own cache
(`gpt.TPCache`), tokens identical to one device's. `tensor_parallel="on"`
without such an axis, or with heads or MLP width that do not divide it,
raises; "auto" then serves on one device with a warning, as JAX does. A TP
step crosses devices between layers, so its executables run eagerly
(`graphs.Executable(eager=True)`): a CUDA graph is one device's work.
The paged layout serves under TP too: the `PagePool` holds one set of
pool arrays per tensor shard under one host allocator (a page id means
the same page in every shard, so the radix cache is unchanged), each
carrier holds a copy of its page table on every shard's device, and a
session's cache is a `gpt.TPCache` of paged shards. Speculative decoding
serves under TP with the drafter whole on the lead device, as JAX places
it, the target's verify, ingest and splice over the TP cache (dense or
paged). An `OnlineLmTrainer` fine-tunes a TP engine on placed masters,
and `update_params` takes such a placed tree shard for shard.

Over a mesh that spans processes (A15 multi-host), as a multi-controller
JAX program serves: every process builds the engine on the same mesh and
makes the same calls with the same arguments in the same order. Each
holds and runs only its own tensor shards (parameters, caches, the paged
pool's arrays, the carriers' page tables), answers on its first entry of
data row 0, and the row-split sums, the vocab-split embedding and the
split head reach every process through the tensor line's group, so every
process has the same logits and samples the same tokens (its seeds come
from the host generator `_seeds`, drawn in the same order). The host
allocator of the paged pool and the radix cache run in every process and
stay identical because the same calls arrive in the same order; no
allocator state crosses processes. The drafter sits whole on each
process's lead. `GenBatcher` refuses such an engine (`mesh.NO_LOCKSTEP`):
its admissions follow timing, which differs between processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import weakref
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from symbiont_tpu_torch.config import LmConfig, validate_spec_draft
from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.graphs import ExecCache, Executable, GraphPool
from symbiont_tpu_torch.kv import paged as paged_mod
from symbiont_tpu_torch.kv.pool import PagePool, PoolExhausted, kv_dtype_label
from symbiont_tpu_torch.kv.radix import RadixCache
from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.models.convert import load_gpt_model, load_hf_config
from symbiont_tpu_torch.models.gpt import GPTConfig, PagedKVCache
from symbiont_tpu_torch.obs.device import local_device_stats
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.obs.hbm import guard_oom, hbm_ledger, peak_temp_bytes
from symbiont_tpu_torch.obs.usage import usage
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from symbiont_tpu_torch.parallel.mesh import axis_size, mesh_device
from symbiont_tpu_torch.parallel.sharding import (
    gather_tree,
    gpt_param_sharding,
    leaf_tensors,
    mesh_of,
    shard_params,
)
from symbiont_tpu_torch.resilience.admission import DEFAULT_TENANT
from symbiont_tpu_torch.train.trainer import tree_leaves
from symbiont_tpu_torch.utils.telemetry import maybe_profile, metrics

log = logging.getLogger(__name__)

# odd 64-bit stride between the seeds of a stream's successive chunks
_CHUNK_SEED_STRIDE = 0x9E3779B97F4A7C15


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 = bytes, 256 = BOS/pad.
    File-free and lossless, so synthetic-weight runs decode to text."""

    vocab_size = 257
    bos_id = 256
    pad_id = 256

    def encode(self, text: str, max_len: int) -> list:
        ids = [self.bos_id] + list(text.encode("utf-8"))
        return ids[:max_len]

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


class LmHFTokenizer:
    """tokenizer.json wrapper with decode (generation needs the reverse
    map); `tokenizers` is imported only when one is loaded."""

    def __init__(self, tokenizer_file):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(str(tokenizer_file))
        self._tok.no_padding()
        self._tok.no_truncation()
        self.pad_id = self._tok.token_to_id("<pad>") or 0
        eos = None
        for name in ("<|endoftext|>", "</s>", "<|end_of_text|>"):
            eos = self._tok.token_to_id(name)
            if eos is not None:
                break
        self.eos_id = -1 if eos is None else eos
        self.bos_id = self.eos_id if self.eos_id >= 0 else 0

    def encode(self, text: str, max_len: int) -> list:
        return self._tok.encode(text).ids[:max_len]

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids])


def _round_up(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class IncrementalDecoder:
    """Growing token sequences → stable text deltas. `push` holds back a
    trailing run of U+FFFD (a multi-byte character split across chunks)
    and emits only a confirmed-stable prefix; `flush` emits the rest, past
    the longest common prefix when a tokenizer's decode rewrote earlier
    output."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._emitted = ""

    def _delta_to(self, text: str) -> str:
        if text.startswith(self._emitted) and len(text) > len(self._emitted):
            delta = text[len(self._emitted):]
            self._emitted = text
            return delta
        return ""

    def push(self, all_tokens) -> str:
        return self._delta_to(self._tok.decode(all_tokens).rstrip("�"))

    def flush(self, all_tokens) -> str:
        text = self._tok.decode(all_tokens)
        if text.startswith(self._emitted):
            return self._delta_to(text)
        i = 0
        for a, b in zip(self._emitted, text):
            if a != b:
                break
            i += 1
        self._emitted = text
        return text[i:]


def lm_model_config(cfg: LmConfig) -> GPTConfig:
    """The LM's geometry before its weights are read: the checkpoint dir's
    config.json, else the synthetic byte-level model's."""
    if cfg.model_dir:
        return GPTConfig.from_hf(load_hf_config(cfg.model_dir))
    return GPTConfig(vocab_size=ByteTokenizer.vocab_size, hidden_size=cfg.hidden_size,
                     num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                     intermediate_size=cfg.intermediate_size,
                     max_position_embeddings=cfg.max_positions, arch=cfg.arch, dtype=cfg.dtype)


def tp_decode(cfg: LmConfig, model_cfg: Optional[GPTConfig], tp: int) -> bool:
    """Whether the LM decodes tensor-parallel over a 'tensor' axis of `tp`
    entries, on JAX's rules; `LmEngine` and the runner both ask here.

    "off" or no such axis: no. "on" without one raises: booting unsharded
    would be a silent memory and latency regression, which is what "on"
    exists to catch. `model_cfg` None (the geometry not read yet): whether
    the axis may shard the LM at all. Otherwise heads, KV heads or MLP
    width that do not divide the axis raise under "on"; under "auto" they
    log and the LM serves on one device (the axis may be there for the
    encoder or training)."""
    if cfg.tensor_parallel == "on" and tp <= 1:
        raise ValueError("tensor_parallel='on' requires a mesh with a 'tensor' axis "
                         f"> 1 (got tensor={tp})")
    if tp <= 1 or cfg.tensor_parallel == "off":
        return False
    if model_cfg is None:
        return True
    bad = [f"{name} ({val})" for name, val in (("num_heads", model_cfg.num_heads),
                                              ("kv_heads", model_cfg.kv_heads),
                                              ("intermediate_size", model_cfg.intermediate_size))
           if val % tp]
    if bad and cfg.tensor_parallel == "on":
        raise ValueError(f"TP decode needs {', '.join(bad)} divisible by the tensor "
                         f"axis ({tp})")
    if bad:
        log.warning("LM tensor_parallel=auto: %s not divisible by tensor axis (%d); "
                    "falling back to single-device decode", ", ".join(bad), tp)
        return False
    return True


def _slot(length) -> torch.Tensor:
    """A cache's host length as the 0-d int64 input of an executable that
    runs at a device slot index."""
    return torch.tensor(length, dtype=torch.int64)


class _CarryDecoder:
    """Decode chunks and speculative rounds as executables bound to one
    carry: the dense or int8 cache (or the paged page table), logits, pos,
    done and kv_valid a chunk reads and writes in place (the state the JAX
    `_decode_chunk_jit` donates), and, for the spec plane, the drafter's
    dense cache (`d_cache0`) and `pending`. On CUDA each shape is a graph
    captured on the carry at its first call and replayed after, a
    generator it draws from registered with it; on the CPU the same
    functions run eagerly. Every executable runs at the device slot index
    the `gpt` functions take from a 0-d `length`, so one graph serves
    every slot:

    - a chunk per (steps, top-k bucket, eos, generator);
    - `spec_first` per (top-k bucket, eos, generator); the draft per
      spec_k (spec_k drafter steps and the extra forward); the verify per
      (spec_k, top-k bucket, eos, generator); one ingest; a track per
      window width (JAX's `_spec_first_jit`, `_draft_chunk_jit`,
      `_verify_chunk_jit`, `_ingest_pending_jit`, `_track_chunk_jit`, one
      executable per shape). Draft and verify stay two replays, so a
      round's draft and verify times keep their meaning.

    The engine lends carriers out of a pool by geometry (`_take_carrier`):
    a `generate_batch` call, a stream or a dense session takes its prefill
    in the carrier's cache (`cache0`), a paged session writes its page
    table into the carrier's (`page_table`, `[rows, n_blocks]`, which the
    paged executables read; under TP a tuple of one copy a tensor shard,
    each on its shard's device), a spec stream or session takes its drafter
    prefill in `draft_cache(dcfg)`, and each draws from the carrier's
    generator (`generator`, reseeded per use) and gives the carrier back
    when it is retired, so the next caller of that geometry replays the
    graphs already captured, as JAX reuses its executable per shape. A
    carrier holds no reference to the engine: a dropped engine frees its
    pool without a cyclic collection.

    Each call adopts the state it is given: a tensor that is not the bound
    one (a new prefill's, or what an eager last chunk hands back) is
    copied into the bound one, which the caller keeps from then on. A
    cache whose slabs or page table are not the bound ones rebinds the
    decoder (its graphs dropped). A splice (`merge_rows`,
    `merge_cache_rows`) writes the bound tensors in place, so a call after
    an admission replays. The caller holds the engine lock."""

    def __init__(self, device, pool: Optional[GraphPool] = None, key=None, cache0=None,
                 page_table: Optional[torch.Tensor] = None, eager: bool = False):
        self.device = torch.device(device)
        self.eager = eager  # a TP engine's executables run eagerly (graphs.Executable)
        self.pool = pool  # the engine's graph pool (None on the CPU)
        self.key = key  # (KV layout, rows, prompt bucket, new bucket)
        self.cache0 = cache0  # dense: the cache a borrower's prefill lands in
        self.page_table = page_table  # paged: the device page table (a tuple under TP)
        self.d_cache0 = None  # the drafter's dense cache at this geometry
        self.pending = None  # [rows] int64, the spec state's pending token
        self.gen: Optional[torch.Generator] = None
        self.carry = None
        self.exes: dict = {}

    def nbytes(self) -> int:
        """Device bytes of the carrier's cache or page table and drafter
        cache."""
        n = 0 if self.d_cache0 is None else gpt_mod.cache_bytes(self.d_cache0)
        if self.page_table is not None:
            return n + sum(quant.tensor_bytes(t) for t in _tables(self.page_table))
        return n + (0 if self.cache0 is None else gpt_mod.cache_bytes(self.cache0))

    def generator(self, seed: int) -> torch.Generator:
        """The carrier's generator, seeded with `seed` (the graphs that
        draw from it are registered with it once)."""
        if self.gen is None:
            self.gen = torch.Generator(device=self.device).manual_seed(seed)
        else:
            self.gen.manual_seed(seed)
        return self.gen

    def draft_cache(self, dcfg: GPTConfig):
        """The drafter's dense cache at this geometry (length 0), made at
        its first use: a spec borrower's drafter prefill lands in it."""
        _, rows, P, new = self.key
        if self.d_cache0 is None:
            self.d_cache0 = gpt_mod.init_cache(dcfg, rows, P + new, torch_dtype(dcfg.dtype),
                                               self.device)
        return self.d_cache0

    def _adopt(self, cache, logits, pos, done, kv_valid):
        if (self.carry is None or self.carry[0].k is not cache.k
                or getattr(self.carry[0], "page_table", None)
                is not getattr(cache, "page_table", None)):
            self.carry = (cache, logits, pos, done, kv_valid)
            self.exes.clear()
            return self.carry
        bound = self.carry[1:]
        for cur, mine in zip((logits, pos, done, kv_valid), bound):
            if cur is not mine:
                mine.copy_(cur)
        return (cache, *bound)

    def _bound_pending(self, pending=None) -> torch.Tensor:
        """The bound `pending` [rows] (made at its first use), `pending`
        copied in when it is another tensor."""
        if self.pending is None:
            self.pending = torch.zeros_like(self.carry[3], dtype=torch.int64)
        if pending is not None and pending is not self.pending:
            self.pending.copy_(pending)
        return self.pending

    def _exe(self, key, params, fn, sig: str, carry=(), gen=None, warm=None,
             warm_scale: int = 1) -> Executable:
        exe = self.exes.get(key)
        if exe is None or exe.params is not params:
            cuda = self.device.type == "cuda" and not self.eager
            exe = self.exes[key] = Executable(
                fn, self.device, pool=self.pool,
                generators=(gen,) if cuda and gen is not None else (), carry=carry,
                warm=warm, warm_scale=warm_scale, signature=sig, eager=self.eager)
            exe.params = params
        return exe

    def chunk(self, params, cfg: GPTConfig, gen: torch.Generator, cache, logits, pos, done,
              kv_valid, steps: int, temps, ks, eos_id: int, sig: str):
        """`steps` decode steps of the model `params`/`cfg` → (cache,
        logits, pos, done, kv_valid, tokens, counted): `gpt.decode_chunk`'s
        results with kv_valid beside them, the state tensors the bound ones
        (the caller keeps them), the cache's host length advanced by
        `steps`."""
        cache, logits, pos, done, kv_valid = self._adopt(cache, logits, pos, done, kv_valid)
        t, k, bucket = gpt_mod._norm_sampling(temps, ks, logits.shape[0], cfg.vocab_size)
        base = cache

        def fn(slot, t, k, n=steps):
            _, lg, ps, dn, toks, counted = gpt_mod.decode_chunk(
                params, base._replace(length=slot), logits, pos, done, kv_valid, gen,
                n, cfg, eos_id=eos_id, sampling=(t, k, bucket))
            logits.copy_(lg)
            pos.copy_(ps)
            done.copy_(dn)
            return toks, counted

        exe = self._exe(("chunk", steps, bucket, eos_id, gen), params, fn, sig,
                        carry=(logits, pos, done), gen=gen,
                        warm=lambda slot, t, k: fn(slot, t, k, n=1),  # one step's kernels
                        warm_scale=steps)
        toks, counted = exe(_slot(cache.length), t, k)
        return (cache._replace(length=cache.length + steps), logits, pos, done, kv_valid, toks,
                counted)

    def spec_first(self, cfg: GPTConfig, gen: torch.Generator, state, temps, ks, eos_id: int,
                   sig: str):
        """plain → spec (`gpt.spec_first`) on the bound state → (state,
        pending, tok, counted): `pending` the bound tensor holding the
        sampled token, `tok` a copy of it, `done` updated in place."""
        cache, logits, pos, done, kv_valid = state = self._adopt(*state)
        pending = self._bound_pending()
        t, k, bucket = gpt_mod._norm_sampling(temps, ks, logits.shape[0], cfg.vocab_size)

        def fn(t, k):
            tok, counted, dn = gpt_mod.spec_first(logits, done, gen, cfg, eos_id=eos_id,
                                                  sampling=(t, k, bucket))
            pending.copy_(tok)
            done.copy_(dn)
            return tok, counted

        exe = self._exe(("spec_first", bucket, eos_id, gen), None, fn, sig,
                        carry=(pending, done), gen=gen)
        tok, counted = exe(t, k)
        return state, pending, tok, counted

    def draft(self, d_params, dcfg: GPTConfig, d_cache, state, pending, spec_k: int, sig: str):
        """The drafter's round (`gpt.draft_chunk`) on the carrier's drafter
        cache (`d_cache` is it, at its host length) → (d_cache, drafts
        [rows, spec_k]), the cache's host length advanced by spec_k + 1."""
        cache, logits, pos, done, kv_valid = self._adopt(*state)
        pending = self._bound_pending(pending)
        base = self.d_cache0

        def fn(slot):
            return gpt_mod.draft_chunk(d_params, base._replace(length=slot), pending, pos, done,
                                       kv_valid, dcfg, spec_k)[1]

        def warm(slot):  # one of the round's spec_k + 1 drafter forwards: its kernels
            gpt_mod.forward(d_params, pending[:, None], base._replace(length=slot), pos[:, None],
                            dcfg, kv_valid)

        drafts = self._exe(("draft", spec_k), d_params, fn, sig, warm=warm,
                           warm_scale=spec_k + 1)(_slot(d_cache.length))
        return base._replace(length=d_cache.length + spec_k + 1), drafts

    def verify(self, params, cfg: GPTConfig, gen: torch.Generator, state, pending, drafts,
               temps, ks, eos_id: int, sig: str):
        """The target's round (`gpt.verify_chunk`) on the bound state →
        (state, pending, out, counted, emitted): pending, pos, done and
        kv_valid written in place, the cache's host length advanced by
        k + 1."""
        cache, logits, pos, done, kv_valid = self._adopt(*state)
        pending = self._bound_pending(pending)
        t, k, bucket = gpt_mod._norm_sampling(temps, ks, logits.shape[0], cfg.vocab_size)
        base = cache

        def fn(slot, drafts, t, k):
            _, pd, ps, dn, _, out, counted, emitted = gpt_mod.verify_chunk(
                params, base._replace(length=slot), pending, drafts, pos, done, kv_valid, gen,
                cfg, eos_id=eos_id, sampling=(t, k, bucket))
            pending.copy_(pd)
            pos.copy_(ps)
            done.copy_(dn)
            return out, counted, emitted

        spec_k = drafts.shape[1]
        exe = self._exe(("verify", spec_k, bucket, eos_id, gen), params, fn, sig,
                        carry=(pending, pos, done, kv_valid), gen=gen)
        out, counted, emitted = exe(_slot(cache.length), drafts, t, k)
        return ((cache._replace(length=cache.length + spec_k + 1), logits, pos, done, kv_valid),
                pending, out, counted, emitted)

    def ingest(self, params, cfg: GPTConfig, state, pending, sig: str):
        """spec → plain (`gpt.ingest_pending`) on the bound state → the
        state, its logits and pos written in place, the cache's host
        length advanced by 1."""
        cache, logits, pos, done, kv_valid = self._adopt(*state)
        pending = self._bound_pending(pending)
        base = cache

        def fn(slot):
            _, lg, ps = gpt_mod.ingest_pending(params, base._replace(length=slot), pending, pos,
                                               done, kv_valid, cfg)
            logits.copy_(lg)
            pos.copy_(ps)
            return ()

        self._exe(("ingest",), params, fn, sig, carry=(logits, pos))(_slot(cache.length))
        return cache._replace(length=cache.length + 1), logits, pos, done, kv_valid

    def track(self, d_params, dcfg: GPTConfig, d_cache, state, toks, start_pos, sig: str):
        """The drafter's lockstep (`gpt.track_chunk`) of `toks` [rows, S]
        at `start_pos` on the carrier's drafter cache (`d_cache`, at its
        host length) → the drafter cache, its host length advanced by S."""
        kv_valid = self._adopt(*state)[4]
        base = self.d_cache0

        def fn(slot, toks, start_pos):
            gpt_mod.track_chunk(d_params, base._replace(length=slot), toks, start_pos, kv_valid,
                                dcfg)
            return ()

        S = toks.shape[1]
        self._exe(("track", S), d_params, fn, sig)(_slot(d_cache.length), toks, start_pos)
        return base._replace(length=d_cache.length + S)


class LmEngine:
    """Owns the LM's parameters on one device and decodes batches of
    prompts. Thread-safe: `_lock` serialises decodes and parameter swaps."""

    def __init__(self, config: Optional[LmConfig] = None, params=None,
                 model_cfg: Optional[GPTConfig] = None, tokenizer=None,
                 mesh=None, draft_params=None, draft_model_cfg=None, device=None):
        self.config = config or LmConfig()
        cfg = self.config
        tp = axis_size(mesh, "tensor")
        tp_candidate = tp_decode(cfg, None, tp)
        # a TP engine answers on the mesh's lead entry
        self.device = resolve_device(mesh_device(mesh, device, cfg.force_cpu) if tp_candidate
                                     else device, cfg.force_cpu)

        if params is None or model_cfg is None:
            if cfg.model_dir:
                params, model_cfg = load_gpt_model(cfg.model_dir)
                log.info("loaded LM checkpoint from %s", cfg.model_dir)
            else:
                # synthetic mode: byte-level vocab, random weights
                model_cfg = lm_model_config(cfg)
                params = gpt_mod.init_params(self._new_generator(0), model_cfg)
                log.warning("LM running with RANDOM weights (no lm model_dir)")
        attn_impl = cfg.attn_impl
        if attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attn_impl must be auto|flash|xla, got {attn_impl!r}")
        if attn_impl == "auto":
            attn_impl = "xla"
        self.model_cfg = dataclasses.replace(model_cfg, dtype=cfg.dtype, attn_impl=attn_impl,
                                             kv_quant=cfg.kv_quant)
        self.mesh = None
        if tp_candidate and tp_decode(cfg, self.model_cfg, tp):
            self.mesh = mesh
            log.info("LM params sharded for TP decode over tensor=%d", tp)
        self.params = self._place_params(params)
        del params

        if tokenizer is None:
            tokenizer = ByteTokenizer()
            if cfg.model_dir and (Path(cfg.model_dir) / "tokenizer.json").exists():
                tokenizer = LmHFTokenizer(Path(cfg.model_dir) / "tokenizer.json")
        self.tokenizer = tokenizer
        self._seeds = np.random.default_rng(cfg.seed)
        self._lock = threading.Lock()
        # decode executables (CUDA graphs on the card) share one pool; their
        # replays are serialised by _lock. Free carriers wait in a pool, one
        # a geometry, least recently returned first, so a geometry's next
        # batch, stream or session replays the graphs its last one captured
        self._graph_pool = GraphPool() if self.device.type == "cuda" else None
        self._free_carriers: dict = {}
        self._carrier_geometries: dict = {}  # geometry -> carriers taken
        self._carrier_counts = {"new": 0, "reused": 0}
        self._carriers_lock = threading.Lock()
        # prefill executables, one per (model, kv_quant, rows, prompt
        # bucket, new bucket), each writing a cache of its own: their graphs
        # keep a pool of their own, and `_stage_lock` serialises their
        # replays with what reads their caches, so an admission prefill
        # replays beside a decoding step() without the engine lock. Lock
        # order: `_lock` before `_stage_lock`. Bounded by their caches'
        # bytes (`_trim_prefills`), not by a count
        self._prefills = ExecCache(None)
        self._stage_pool = GraphPool() if self.device.type == "cuda" else None
        self._stage_lock = threading.Lock()
        # prefill captures by model ("target", "draft"): on the card each
        # runs the prefill once more eagerly (its B1 launches included)
        self.prefill_captures = {"target": 0, "draft": 0}
        # durability plane (resilience/genlog.py): when set, streams and
        # session rows with a task_id journal a resume snapshot at each
        # chunk boundary, from host values in hand (no device sync of its
        # own); the service owns the terminal mark_done, so a crash in the
        # publish window still resumes
        self.journal = None
        # prefill shapes (rows, prompt bucket, new bucket) already run by
        # session starts and admissions, so captured: the batcher's guess of
        # whether an admission prefill is cheap (GenBatcher._filter_candidates)
        self._prefill_shapes: set = set()
        self.stats = {"generate_calls": 0, "tokens_generated": 0, "decode_s": 0.0}
        # live sessions (BatchSession registers itself), weak so a finished
        # one drops out of the KV gauges; their own lock, since sessions
        # register from executor threads while scrapes iterate
        self._sessions: "weakref.WeakSet" = weakref.WeakSet()
        self._sessions_lock = threading.Lock()
        # paged KV: one engine-wide page pool (one set of arrays a tensor
        # shard under TP, one allocator) and, optionally, the radix prefix
        # cache over committed prompt pages; the dense layout leaves both
        # None
        self.pool: Optional[PagePool] = None
        self.radix: Optional[RadixCache] = None
        if cfg.kv_layout == "paged":
            mc = self.model_cfg
            n_pages = cfg.kv_pool_pages or self._auto_pool_pages()
            self.pool = PagePool(mc.num_layers, n_pages, cfg.kv_page_tokens,
                                 mc.kv_heads // axis_size(self.mesh, "tensor"),
                                 mc.head_dim, torch_dtype(mc.dtype),
                                 quantized=mc.kv_quant == "int8",
                                 dtype_label=kv_dtype_label(mc.dtype, mc.kv_quant),
                                 devices=gpt_mod.cache_devices(self.params, self.device))
            if cfg.kv_radix:
                self.radix = RadixCache(self.pool, cfg.kv_page_tokens)
            log.info("paged KV pool: %d pages x %d tokens (%.1f MiB%s)", n_pages,
                     cfg.kv_page_tokens, self.pool.device_bytes / (1 << 20),
                     ", radix on" if self.radix is not None else "")
        # speculative decoding: a small drafter proposes spec_k greedy
        # tokens a round on its own dense, unquantized cache; acceptance
        # reads only the proposed ids, so the target's layout and KV
        # quantization cannot break token identity
        self._draft = None
        self.spec_k = int(cfg.spec_k)
        self._spec_proposed = 0  # draft tokens offered to verify_chunk
        self._spec_accepted = 0  # ... of which the target accepted
        if draft_params is not None or draft_model_cfg is not None:
            if draft_params is None or draft_model_cfg is None:
                raise ValueError("draft_params and draft_model_cfg must be passed together")
            self._adopt_draft(draft_params, draft_model_cfg)
        elif cfg.spec_draft_model:
            if not Path(cfg.spec_draft_model).is_dir():
                # a missing drafter costs speed only: decode plain
                log.warning("spec_draft_model %r not found: speculative decoding disabled, "
                            "plain decode unaffected", cfg.spec_draft_model)
            else:
                if cfg.model_dir:
                    # tokenizer and vocab parity from the checkpoints'
                    # metadata, before any weight is read
                    validate_spec_draft(cfg.model_dir, cfg.spec_draft_model)
                self._adopt_draft(*load_gpt_model(cfg.spec_draft_model))
        self._register_gauges()

    def _adopt_draft(self, d_params, d_cfg: GPTConfig) -> None:
        """Check and place the drafter. Vocab parity is the one hard
        requirement (token ids must mean the same to both models); its
        attention follows the target's resolved `attn_impl`, so a drafter
        prefill runs B1 under "flash". Floating leaves are cast to the
        drafter's own dtype and never quantized."""
        if d_cfg.vocab_size != self.model_cfg.vocab_size:
            raise ValueError(f"spec draft vocab_size {d_cfg.vocab_size} != target "
                             f"{self.model_cfg.vocab_size}: drafter and target must share a "
                             "tokenizer")
        d_cfg = dataclasses.replace(d_cfg, attn_impl=self.model_cfg.attn_impl)
        dtype = torch_dtype(d_cfg.dtype)

        def place(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return quant.cast_params(a.to(self.device), dtype)

        self._draft = (quant.tree_map(place, d_params), d_cfg)
        log.info("speculative decoding on: drafter %d layers x %d hidden, k=%d",
                 d_cfg.num_layers, d_cfg.hidden_size, self.spec_k)

    def _largest_span(self) -> int:
        """Cache slots of a row at the largest usable (prompt, new) bucket
        pair: the worst case of the page quote, the pool sizing and the
        dense bytes forecast."""
        cfg = self.config
        new_b = max(cfg.new_token_buckets)
        cap = self.model_cfg.max_position_embeddings - new_b
        usable = [b for b in cfg.prompt_buckets if b <= cap]
        return (usable[-1] if usable else max(cap, 1)) + new_b

    def _auto_pool_pages(self) -> int:
        """`kv_pool_pages=0`: the pages of one session batch at the largest
        bucket pair (every row at its worst case), twice over for radix
        retention, plus the scratch page."""
        cfg = self.config
        rows = max(cfg.session_min_rows, cfg.gen_max_batch, 1)
        bb = 1 << (rows - 1).bit_length() if rows > 1 else 1
        return 2 * bb * -(-self._largest_span() // cfg.kv_page_tokens) + 1

    def _new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _draw_seed(self) -> int:
        """One draw from the engine's seed sequence, on the host. The
        caller holds the engine lock."""
        return int(self._seeds.integers(0, 2 ** 62))

    def _chunk_generator(self, base: int, n: int,
                         carrier: Optional["_CarryDecoder"] = None) -> torch.Generator:
        """The generator of a stream's n-th chunk or round, a function of
        its base seed and n only: the stream's carrier's generator reseeded
        (the one its decode graphs are registered with), or a new one."""
        seed = (base + n * _CHUNK_SEED_STRIDE) % (1 << 63)
        return self._new_generator(seed) if carrier is None else carrier.generator(seed)

    def _live_sessions(self) -> list:
        with self._sessions_lock:
            return [s for s in self._sessions if not s.done()]

    def _register_gauges(self) -> None:
        """The LM plane's gauges and device-memory claims, weakref-bound so
        the process-global registry and ledger never pin a dead engine.
        Readers never take the engine lock: a scrape must not wait behind a
        decode."""
        def live_rows(sessions):
            return sum(sum(1 for r in s.rows if r is not None) for s in sessions)

        def kv_stranded(lm):
            # rows holding KV but not live: on the dense layout batch-bucket
            # padding and finished or cancelled rows; paged rows return
            # their pages when they end, so this reads 0 there
            live, alloc = lm.kv_row_counts()
            return alloc - live

        def dense_kv_bytes(lm):
            return sum(gpt_mod.cache_bytes(s._cache) for s in lm._live_sessions())

        def kv_bytes(lm):
            # paged: the pool is the resident allocation
            return lm.pool.device_bytes if lm.pool is not None else dense_kv_bytes(lm)

        def kv_rows_per_gib(lm):
            sessions = lm._live_sessions()
            if lm.pool is not None:  # live rows per GiB of live pages
                occupied = lm.pool.pages_live * lm.pool.device_bytes / lm.pool.n_pages
                return round(live_rows(sessions) * (1 << 30) / occupied, 1) if occupied else 0.0
            total = sum(gpt_mod.cache_bytes(s._cache) for s in sessions)
            rows = sum(s.bb for s in sessions)
            return round(rows * (1 << 30) / total, 1) if total else 0.0

        def page_fragmentation(lm):
            # mapped page slots live rows do not fill (left padding inside
            # prompt pages, the open tail of the newest decode page), as a
            # share of every slot they map
            toks = slots = 0
            for sess in lm._live_sessions():
                t, sl = sess.page_occupancy()
                toks, slots = toks + t, slots + sl
            return round(100.0 * (1.0 - toks / slots), 2) if slots else 0.0

        def spec_accept(lm):
            p = lm._spec_proposed
            return round(lm._spec_accepted / p, 4) if p else 0.0

        def tok_per_s(lm):
            toks, secs = lm.stats["tokens_generated"], lm.stats["decode_s"]
            return toks / secs if secs > 0 else 0.0

        labels = {"service": "lm",
                  "kv_dtype": kv_dtype_label(self.model_cfg.dtype, self.model_cfg.kv_quant)}
        gauges = [("lm.kv_stranded_rows", kv_stranded),
                  ("lm.kv_rows_active", lambda lm: lm.kv_row_counts()[0]),
                  ("lm.kv_rows_allocated", lambda lm: lm.kv_rows_allocated()),
                  ("lm.kv_cache_bytes", kv_bytes),
                  ("lm.kv_rows_per_gib", kv_rows_per_gib),
                  ("lm.decode_tok_per_s", tok_per_s),
                  # None retires the gauge: right on the CPU, which keeps no
                  # memory statistics
                  ("lm.hbm_headroom_bytes", lambda lm: lm.hbm_headroom_bytes())]
        if self.pool is not None:  # replaces the pool's placeholder
            gauges.append(("kv.page_fragmentation_pct", page_fragmentation))
        if self._draft is not None:
            gauges.append(("lm.spec_accept_rate", spec_accept))
        for name, reader in gauges:
            metrics.register_weakref_gauge(name, self, reader, labels=labels)
        hbm_ledger.claim("lm.params", self, lambda lm: quant.param_bytes(lm.params))
        if self._draft is not None:
            hbm_ledger.claim("lm.drafter", self, lambda lm: quant.param_bytes(lm._draft[0]))
        if self.pool is None:  # the pool claims its own bytes
            hbm_ledger.claim("lm.kv_cache", self, dense_kv_bytes)
        # the free carriers' caches (a lent one is its session's lm.kv_cache)
        hbm_ledger.claim("lm.carrier_pool", self, lambda lm: lm.carrier_stats()["free_bytes"])
        if self._graph_pool is not None:
            hbm_ledger.claim("lm.decode_graphs", self, lambda lm: lm._graph_pool.nbytes())
            hbm_ledger.claim("lm.prefill_graphs", self, lambda lm: lm.prefill_bytes())

    def hbm_headroom_bytes(self) -> Optional[int]:
        """Free bytes of the engine's card: its total memory less the bytes
        of live tensors (`obs/device.py`). None on the CPU, which keeps no
        such statistics: callers skip the bytes forecast there."""
        if self.device.type != "cuda":
            return None
        index = self.device.index if self.device.index is not None else 0
        for idx, _platform, stats in local_device_stats():
            if idx == index:
                return max(0, int(stats["bytes_limit"]) - int(stats["bytes_in_use"]))
        return None

    def param_bytes(self) -> int:
        """Device bytes of the parameters (the `lm.params` claim)."""
        return quant.param_bytes(self.params)

    def _note_param_bytes(self, params, storage: str) -> None:
        metrics.gauge_set("lm.param_bytes", quant.param_bytes(params),
                          labels={"service": "lm", "dtype": storage})

    def _place_params(self, params):
        """Parameters onto the device leaf by leaf: each floating leaf cast
        to the compute dtype FIRST, then quantized per `config.quantize`,
        as the JAX `_place_params` orders it, so a quantized leaf always
        ends narrow and no full float32 tree is ever held on the device.
        On a TP mesh the tree is then placed by `shard_params` on the
        megatron rules (a `QuantTensor`'s codes on its kernel's spec, its
        scales on the last entry), after `lm.param_bytes` has noted the
        narrow storage. Used by `__init__` and `update_params`."""
        mode = self.config.quantize
        dtype = torch_dtype(self.model_cfg.dtype)

        def place(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            a = quant.cast_params(a.to(self.device), dtype)
            return quant.quantize_params(a, mode)

        params = quant.tree_map(place, params)
        self._note_param_bytes(params, mode if mode != "none" else self.model_cfg.dtype)
        if self.mesh is None:
            return params
        return shard_params(self.mesh, params,
                            gpt_param_sharding(self.mesh, params, arch=self.model_cfg.arch))

    # ------------------------------------------------------------------ gen

    def _prepare_prompts(self, prompts: Sequence[str], max_new: int, min_rows: int = 1,
                         encoded=None):
        """Pick the new-token bucket and check it fits; encode the prompts
        (or take `encoded` id lists), keep each one's tail up to the
        largest usable prompt bucket, BOS for an empty one; pad the batch
        to a power of two (at least `min_rows`), padding rows a one-token
        BOS prompt. Returns (prompt_ids [bb, P], prompt_mask [bb, P],
        new_bucket) as int32 numpy."""
        cfg = self.config
        new_bucket = _round_up(max_new, cfg.new_token_buckets)
        # P + new_bucket must fit the positions: larger prompt buckets are
        # unusable for this request
        cap = self.model_cfg.max_position_embeddings - new_bucket
        if cap < 1:
            raise ValueError(
                f"max_new_tokens {max_new} (bucket {new_bucket}) leaves no "
                f"room in {self.model_cfg.max_position_embeddings} positions")
        avail = [b for b in cfg.prompt_buckets if b <= cap] or [cap]
        if encoded is None:
            encoded = [self.tokenizer.encode(p or "", 1 << 30) for p in prompts]
        bos = getattr(self.tokenizer, "bos_id", 0)
        encoded = [list(ids)[-avail[-1]:] or [bos] for ids in encoded]  # the tail wins
        B = len(encoded)
        bb = 1 << (B - 1).bit_length() if B > 1 else 1
        if min_rows > 1:
            bb = max(bb, 1 << (min_rows - 1).bit_length())
        P = _round_up(max(len(e) for e in encoded), avail)
        prompt_ids = np.full((bb, P), getattr(self.tokenizer, "pad_id", 0), np.int32)
        prompt_mask = np.zeros((bb, P), np.int32)
        for i, ids in enumerate(encoded):
            prompt_ids[i, : len(ids)] = ids
            prompt_mask[i, : len(ids)] = 1
        prompt_ids[B:, 0] = bos  # padding rows: a minimal one-token prompt
        prompt_mask[B:, 0] = 1
        return prompt_ids, prompt_mask, new_bucket

    def generate(self, prompt: str, max_new_tokens: int,
                 temperature: Optional[float] = None, top_k: Optional[int] = None) -> str:
        """Prompt → generated text."""
        return self.generate_batch([prompt], [max_new_tokens],
                                   temperature=temperature, top_k=top_k)[0]

    def _norm_sampling_rows(self, value, default, bb: int, n: int, cast):
        """Scalar-or-per-request sampling parameter → a per-row list of
        length bb (None → the engine's default, element-wise too); padding
        rows decode greedily."""
        if value is None:
            value = default
        if isinstance(value, (list, tuple, np.ndarray)):
            if len(value) != n:
                raise ValueError(f"per-request sampling list length {len(value)} != {n}")
            rows = [cast(default if v is None else v) for v in value]
        else:
            rows = [cast(value)] * n
        return rows + [cast(0)] * (bb - n)

    def _device_ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device).long()

    def generate_batch(self, prompts: Sequence[str], max_new_tokens: Sequence[int],
                       temperature=None, top_k=None) -> list:
        """B prompts decoded together at one (prompt bucket, new-token
        bucket) shape. Rows are right-aligned inside `gpt.generate`, so each
        row's output is independent of its batchmates (greedy decode of a
        batch == greedy decode of each prompt alone). Each request's
        max_new_tokens trims the shared bucket; temperature and top_k are
        scalars or per-request sequences."""
        cfg = self.config
        if len(prompts) != len(max_new_tokens):
            raise ValueError("prompts and max_new_tokens length mismatch")
        prompt_ids, prompt_mask, new_bucket = self._prepare_prompts(
            prompts, max(max_new_tokens))
        bb, n = prompt_ids.shape[0], len(prompts)
        temps = self._norm_sampling_rows(temperature, cfg.temperature, bb, n, float)
        ks = self._norm_sampling_rows(top_k, cfg.top_k, bb, n, int)
        eos_id = getattr(self.tokenizer, "eos_id", -1)
        with self._lock:
            t0 = time.perf_counter()
            with maybe_profile("engine.generate"), torch.inference_mode():
                tokens, lengths = self._decode_batch(prompt_ids, prompt_mask, new_bucket,
                                                     temps, ks, int(eos_id))
                # the call's one fetch: it waits for the whole decode
                host = torch.cat((tokens, lengths[:, None].to(tokens.dtype)), dim=1).cpu().numpy()
                tokens, lengths = host[:, :-1], host[:, -1]
            dispatch_ledger.note_host_sync("LmEngine.generate_batch")
            self.stats["generate_calls"] += 1
            self.stats["decode_s"] += time.perf_counter() - t0
            out = []
            for i, want in enumerate(max_new_tokens):  # drops the padding rows
                k = min(int(lengths[i]), int(want))
                self.stats["tokens_generated"] += k
                out.append(self.tokenizer.decode(tokens[i, :k]))
        return out

    def _take_carrier(self, bb: int, P: int, new_bucket: int,
                      paged: bool = False) -> _CarryDecoder:
        """The free carrier of this geometry from the pool, or a new one:
        dense, with a zeroed dense (or int8) cache; paged, with a device
        page table `[bb, n_blocks]` on the scratch page. `_give_carrier`
        returns it. Counts the take as a reuse or a new carrier, by
        geometry, whose first entry is the KV layout (`kv_quant`, or
        "paged/" and it)."""
        cfg = self.model_cfg
        key = ((f"paged/{cfg.kv_quant}" if paged else cfg.kv_quant), bb, P, new_bucket)
        with self._carriers_lock:
            self._carrier_geometries[key] = self._carrier_geometries.get(key, 0) + 1
            dec = self._free_carriers.pop(key, None)
            self._carrier_counts["reused" if dec is not None else "new"] += 1
        if dec is not None:
            return dec
        if paged:
            n_blocks = -(-(P + new_bucket) // self.pool.page_tokens)
            tables = tuple(torch.full((bb, n_blocks), paged_mod.SCRATCH_PAGE, dtype=torch.int64,
                                      device=d)
                           for d in gpt_mod.cache_devices(self.params, self.device))
            return _CarryDecoder(self.device, self._graph_pool, key,
                                 page_table=tables if self.mesh is not None else tables[0],
                                 eager=self.mesh is not None)
        return _CarryDecoder(self.device, self._graph_pool, key,
                             gpt_mod.new_cache(self.params, cfg, bb, P + new_bucket,
                                               torch_dtype(cfg.dtype), self.device),
                             eager=self.mesh is not None)

    def _give_carrier(self, dec: _CarryDecoder) -> None:
        """Back into the pool: one free carrier a geometry (the one given
        back last), the least recently returned of its layout (dense caches,
        or paged page tables) dropped first past `_carrier_budget` bytes."""
        def paged(key):
            return key[0].startswith("paged/")

        with self._carriers_lock:
            self._free_carriers.pop(dec.key, None)
            self._free_carriers[dec.key] = dec
            budget = self._carrier_budget(dec)
            mine = [k for k in self._free_carriers if paged(k) == paged(dec.key)]
            held = sum(self._free_carriers[k].nbytes() for k in mine)
            for k in mine:
                if held <= budget:
                    break
                held -= self._free_carriers.pop(k).nbytes()

    def _carrier_budget(self, dec: _CarryDecoder) -> int:
        """The free carriers' bytes bound: `_session_bytes` read off `dec`'s
        bytes per row and slot."""
        _, bb, P, new = dec.key
        return self._session_bytes(dec.nbytes(), bb, P + new)

    def _session_bytes(self, nbytes: int, rows: int, slots: int) -> int:
        """The cache of one session at the largest geometry the
        configuration admits (`gen_max_batch` rows rounded to a power of
        two, the largest prompt and new-token buckets within the
        positions), what a single request of that geometry would hold
        anyway: scaled from `nbytes`, what a cache of the same model at
        `rows` x `slots` holds."""
        cfg = self.config
        most = min(self.model_cfg.max_position_embeddings,
                   max(cfg.prompt_buckets) + max(cfg.new_token_buckets))
        bb = 1 << (max(1, cfg.gen_max_batch) - 1).bit_length()
        return nbytes * bb * most // (rows * slots)

    def carrier_stats(self) -> dict:
        """The carrier pool's traffic: takes by geometry, how many found a
        free carrier of theirs (their graphs already captured), and the
        free carriers held with their bytes."""
        with self._carriers_lock:
            free = list(self._free_carriers.values())
            geoms = dict(self._carrier_geometries)
            counts = dict(self._carrier_counts)
        taken = sum(geoms.values())
        return {"takes": taken, "geometries": len(geoms), "by_geometry": geoms, **counts,
                "repeat_share": counts["reused"] / taken if taken else 0.0,
                "free": len(free), "free_bytes": sum(c.nbytes() for c in free)}

    def _decode_batch(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                      new_bucket: int, temps, ks, eos_id: int):
        """`gpt.generate` on a carrier of this geometry: the prefill's
        executable replayed into its cache, then the decode as chunks of
        `stream_chunk` steps through the carrier's executable (the graph a
        stream or session of the geometry replays too; a shorter last chunk
        runs eagerly), sampling from the carrier's generator seeded by one
        draw from the engine's → (tokens, lengths) on the device. Call
        under the lock and inference mode."""
        bb, P = prompt_ids.shape
        chunk = max(1, min(self.config.stream_chunk, new_bucket))
        dec = self._take_carrier(bb, P, new_bucket)
        try:
            gen = dec.generator(self._draw_seed())
            cache, logits, kv_valid, pos = self._prefill(self.params, prompt_ids, prompt_mask,
                                                         new_bucket, cache=dec.cache0)
            done = torch.zeros((bb,), dtype=torch.bool, device=self.device)
            toks, counted = [], []
            for start in range(0, new_bucket, chunk):
                n = min(chunk, new_bucket - start)
                if n == chunk:
                    cache, logits, pos, done, kv_valid, t, c = dec.chunk(
                        self.params, self.model_cfg, gen, cache, logits, pos, done, kv_valid, n,
                        temps, ks, eos_id, f"lm.decode_chunk[P={P},B={bb},chunk={n}]")
                else:
                    cache, logits, pos, done, t, c = gpt_mod.decode_chunk(
                        self.params, cache, logits, pos, done, kv_valid, gen, n,
                        self.model_cfg, temperature=temps, top_k=ks, eos_id=eos_id)
                toks.append(t)
                counted.append(c)
        finally:
            self._give_carrier(dec)
        return torch.cat(toks, dim=1), torch.cat(counted, dim=1).sum(dim=1)

    def _prefill(self, params, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                 new_bucket: int, cache=None, adopt=None, model: str = "target"):
        """`gpt.prefill` of host prompt arrays through the executable of
        (model, kv_quant, rows, P, new bucket) → (cache, logits, kv_valid,
        prompt_len) on the device; `model` "target" (`params` the target's,
        possibly an older tree an admission read) or "draft" (the drafter's
        own). The executable writes a cache of its own, and the caller takes
        what it keeps of it under `_stage_lock`: `cache` (a carrier's, of
        that geometry, length 0) gets the prompt slots copied in and is
        returned; `adopt(staged)` reads the staged cache in place (a paged
        session's scatter into its pages; the cache returned is None);
        otherwise the cache returned is a clone. Call under
        `torch.inference_mode()`.

        The first call of a key captures its graph on the card (there is no
        eager fallback); its graph pool's growth is the executable's
        `temp_bytes` in the dispatch ledger, which `_admit_bytes_forecast`
        reads."""
        cfg = self.model_cfg if model == "target" else self._draft[1]
        bb, P = prompt_ids.shape
        key = (model, cfg.kv_quant, bb, P, new_bucket)
        cuda = self.device.type == "cuda" and self.mesh is None
        ids, mask = (torch.from_numpy(np.ascontiguousarray(a)).long()
                     for a in (prompt_ids, prompt_mask))
        with self._stage_lock:
            exe = self._prefills.get(key)
            fresh = exe is None or exe.params is not params
            if fresh:
                exe = self._prefill_exe(key, params, cfg, stale=exe)
            logits, kv_valid, prompt_len = exe(ids, mask)
            if fresh and cuda:
                self.prefill_captures[model] += 1
            if fresh:
                self._trim_prefills(key)
            staged = exe.cache._replace(length=P)
            if adopt is not None:
                adopt(staged)
                out = None
            elif cache is not None:
                for dst, src in zip(gpt_mod.cache_tensors(cache), gpt_mod.cache_tensors(staged),
                                    strict=True):
                    dst[:, :, :P].copy_(src[:, :, :P])
                out = cache._replace(length=P)
            else:
                out = gpt_mod.clone_cache(staged)
        return out, logits, kv_valid, prompt_len

    def _prefill_exe(self, key, params, cfg: GPTConfig, stale=None) -> Executable:
        """The prefill executable of `key` on `params`, cached (in place of
        `stale`, one on older parameters, whose cache it takes over)."""
        _, _, bb, P, new_bucket = key
        cache = (stale.cache if stale is not None else
                 gpt_mod.new_cache(params, cfg, bb, P + new_bucket, torch_dtype(cfg.dtype),
                                   self.device))

        def fn(ids, mask):
            _, logits, kv_valid, prompt_len = gpt_mod.prefill(params, ids, mask, cfg, new_bucket,
                                                              cache=cache)
            return logits, kv_valid, prompt_len

        name = "lm.prefill" if key[0] == "target" else "lm.draft_prefill"
        sig = f"{name}[P={P},B={bb},new={new_bucket}]"
        exe = Executable(fn, self.device, pool=self._stage_pool, signature=sig,
                         eager=self.mesh is not None)
        exe.params, exe.cache = params, cache
        if stale is not None:
            self._prefills.drop(key)
        return self._prefills.put(key, exe)[0]

    def _trim_prefills(self, keep) -> None:
        """Drop the least recently used prefill executables of `keep`'s
        model, never `keep`'s own, while their caches hold more than
        `_session_bytes`. On the card the stream is synchronised first: a
        replay of one may still be running. Call under `_stage_lock`."""
        mine = [(k, gpt_mod.cache_bytes(e.cache)) for k, e in self._prefills.items()
                if k[0] == keep[0]]
        held = sum(n for _, n in mine)
        _, _, bb, P, new = keep
        budget = self._session_bytes(dict(mine)[keep], bb, P + new)
        drop = []
        for k, n in mine:
            if held <= budget:
                break
            if k != keep:
                drop.append(k)
                held -= n
        if drop and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for k in drop:
            self._prefills.drop(k)
            if k[0] == "target":
                self._prefill_shapes.discard(k[2:])  # no longer warm

    def prefill_stats(self) -> dict:
        """The prefill executables held, by model ("target", "draft"):
        their shapes, their caches' bytes and those caches' bound
        (`_trim_prefills`); and the bytes allocated in their graphs' pool."""
        out = {"shapes": {}, "cache_bytes": {}, "budget": {},
               "pool_bytes": self._stage_pool.nbytes() if self._stage_pool is not None else 0}
        for (model, _, bb, P, new), exe in self._prefills.items():
            n = gpt_mod.cache_bytes(exe.cache)
            out["shapes"][model] = out["shapes"].get(model, 0) + 1
            out["cache_bytes"][model] = out["cache_bytes"].get(model, 0) + n
            out["budget"][model] = self._session_bytes(n, bb, P + new)
        return out

    def prefill_bytes(self) -> int:
        """Device bytes the prefill executables hold: their caches and the
        pool their graphs share (the `lm.prefill_graphs` claim)."""
        st = self.prefill_stats()
        return sum(st["cache_bytes"].values()) + st["pool_bytes"]

    def _draft_prefill(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                       new_bucket: int, cache=None):
        """The drafter's dense cache at the target's (prompt, new) geometry,
        slot for slot the target's, so both share one kv_valid, pos and
        done, out of the drafter's prefill executable: its prompt slots
        copied into `cache` (a carrier's `draft_cache`), or a clone. Call
        under `torch.inference_mode()`."""
        return self._prefill(self._draft[0], prompt_ids, prompt_mask, new_bucket, cache=cache,
                             model="draft")[0]

    def generate_stream(self, prompt: str, max_new_tokens: int,
                        temperature: Optional[float] = None, top_k: Optional[int] = None,
                        tenant: Optional[str] = None, task_id: Optional[str] = None,
                        stream: bool = True, resume: Optional[dict] = None):
        """`_generate_stream_impl` with every advance under
        `guard_oom("lm.generate_stream")`: a device OOM out of the prefill
        or a chunk leaves its postmortem and reaches the consumer
        unchanged."""
        gen = self._generate_stream_impl(prompt, max_new_tokens, temperature=temperature,
                                         top_k=top_k, tenant=tenant, task_id=task_id,
                                         stream=stream, resume=resume)
        while True:
            try:
                with guard_oom("lm.generate_stream"):
                    item = next(gen)
            except StopIteration:
                return
            yield item

    def _generate_stream_impl(self, prompt: str, max_new_tokens: int,
                              temperature: Optional[float] = None,
                              top_k: Optional[int] = None, tenant: Optional[str] = None,
                              task_id: Optional[str] = None, stream: bool = True,
                              resume: Optional[dict] = None):
        """Streaming decode: one prefill, then chunks of `stream_chunk`
        steps through `gpt.decode_chunk` on the carried state, each chunk's
        tokens turned into a text delta by `IncrementalDecoder`. Greedy
        deltas join to exactly `generate()`'s text: both run the same steps
        at the same one-row shape.

        With a drafter the loop runs draft + verify rounds instead of plain
        chunks while the slots left allow a worst-case round (one token for
        spec_k + 1 slots) and a plain finish; then it folds the pending
        token back in and decodes plain to the end. The bucket request
        carries spec_k slots of headroom for that margin. Greedy rounds give
        plain decode's tokens up to floating-point near-ties: a forward of
        k + 1 tokens, or a cache with more slots, rounds differently from
        one-token steps (bf16 random-weight logits tie often).

        Durability: with `task_id` set and a journal attached, every chunk
        appends a resume snapshot before its delta is yielded, so a crash
        anywhere leaves a tail whose replay re-emits at most one delivered
        chunk (deduped by seq at the SSE hub) and loses none. `resume` is
        such a tail: the journalled prompt + generated prefix is
        re-prefilled exactly (content-relative positions continue greedy
        decode token for token), the last journalled chunk's delta is
        replayed at its original seq, and the chunk generators go on from
        the journalled base seed and chunk count. A snapshot taken in the
        spec state journals its last token as the un-ingested `pending`:
        it stays out of the re-prefill, and the slot margin is restored so
        every mode and clamp decision replays. The orphan is adopted in
        this engine's journal before anything is emitted.

        The engine lock is held around the prefill and each chunk or round,
        never across a yield, so a consumer that stops reading starves no
        other caller; the stream's caches belong to this generator frame, so
        nothing that runs between its chunks can touch them. `stats` and the
        usage ledger are charged in `finally`, also when the consumer
        closes the stream."""
        cfg = self.config
        temperature = float(cfg.temperature if temperature is None else temperature)
        top_k = int(cfg.top_k if top_k is None else top_k)
        tenant = tenant or DEFAULT_TENANT
        eos_id = int(getattr(self.tokenizer, "eos_id", -1))
        jr = self.journal
        journaling = jr is not None and jr.enabled and bool(task_id)
        spec_on = self._draft is not None
        spec_cap = spec_on  # at the stream's start; spec_on may fall back
        headroom = self.spec_k if spec_on else 0
        all_tokens: list = []
        seq = 0
        chunk_start = 0
        decoder = IncrementalDecoder(self.tokenizer)
        if resume is not None:
            all_tokens = [int(t) for t in (resume.get("tokens") or [])]
            chunk_start = int(resume.get("chunk_start") or 0)
            seq = int(resume.get("seq") or 0)
            decoder._emitted = resume.get("text") or ""
            my_prompt_ids = [int(t) for t in resume["prompt_ids"]]
            # a spec-state snapshot's last token was not in the dead
            # worker's cache: it stays out of the re-prefill and keeps its
            # slot (the + cut)
            cut = 1 if (spec_on and resume.get("spec") and all_tokens) else 0
            body = all_tokens[:len(all_tokens) - cut]
            remaining = max(1, max_new_tokens - len(all_tokens) + cut)
            # the spec/plain decision and the plain-chunk clamp read the
            # slot margin, so a resume reproduces the journalled margin
            # exactly; the original bucket held it, so a bucket fits
            spec_slots = resume.get("spec_slots") if spec_on else None
            want_slots = (max(remaining, int(spec_slots)) if spec_slots is not None
                          else remaining + headroom)
            prompt_ids, prompt_mask, new_bucket = self._prepare_prompts(
                [""], want_slots, encoded=[my_prompt_ids + body])
            max_new_tokens = min(max_new_tokens, len(all_tokens) + new_bucket - cut)
        else:
            cut = 0
            prompt_ids, prompt_mask, new_bucket = self._prepare_prompts(
                [prompt], max_new_tokens + headroom)
            # the cache has new_bucket decode slots: the largest bucket caps
            max_new_tokens = min(max_new_tokens, new_bucket)
            my_prompt_ids = prompt_ids[0][prompt_mask[0].astype(bool)].tolist()
        usage.note(tenant, tokens_in=int(prompt_mask[0].sum()))
        chunk = min(cfg.stream_chunk, new_bucket)
        bb, P = prompt_ids.shape
        sampling = dict(temperature=temperature, top_k=top_k, eos_id=eos_id)
        decode_s = 0.0
        key_base = None  # what the journal records of a sampled stream's draws
        n_splits = 0  # chunk generators consumed from the base seed
        with self._lock:
            t0 = time.perf_counter()  # inside the lock: this stream's own work
            base = self._draw_seed()
            if resume is not None and resume.get("key") is not None:
                key = [int(x) for x in resume["key"]]
                if len(key) != 1:
                    raise ValueError(
                        f"resume key of {len(key)} words: a sampled tail resumes only "
                        "on the package whose engine journalled it")
                base, key_base = key[0], key
                n_splits = int(resume.get("key_splits") or 0)
            elif journaling and temperature > 0.0:
                key_base = [base]
            # the stream's carrier: its cache takes the prefill's prompt
            # slots, and full plain chunks replay its graph
            carrier = self._take_carrier(bb, P, new_bucket)
            with torch.inference_mode():
                cache, logits, kv_valid, pos = self._prefill(self.params, prompt_ids,
                                                             prompt_mask, new_bucket,
                                                             cache=carrier.cache0)
                done = torch.zeros((bb,), dtype=torch.bool, device=self.device)
                dt = time.perf_counter() - t0
                if spec_on:
                    # the drafter's prompt slots into the carrier's drafter
                    # cache, which the round executables are bound to
                    d_cache = self._draft_prefill(prompt_ids, prompt_mask, new_bucket,
                                                  cache=carrier.draft_cache(self._draft[1]))
            decode_s += time.perf_counter() - t0
        dispatch_ledger.note_dispatch(f"lm.prefill[P={P},B={bb},new={new_bucket}]", dt)
        if spec_on:
            dispatch_ledger.note_dispatch(f"lm.draft_prefill[P={P},B={bb},new={new_bucket}]",
                                          decode_s - dt)
        # spec state: `pending`, the last emitted token, stays out of both
        # caches until the next round writes it (or ingest_pending folds it
        # in); slots_used runs ahead of the tokens by the rejected holes
        pending = None
        slots_used = 0
        stop = False
        S = self.spec_k + 1
        if resume is not None and spec_on and resume.get("spec_slots") is not None:
            slots_used = max(0, new_bucket - int(resume["spec_slots"]))
        if cut:
            # a spec-state tail: its last token is the pending one
            pending = torch.tensor([all_tokens[-1]], dtype=torch.long, device=self.device)

        def _snapshot(text_before: str) -> dict:
            return {"task_id": task_id, "tenant": tenant, "stream": stream,
                    "prompt_ids": my_prompt_ids, "max_new": int(max_new_tokens),
                    "temperature": temperature, "top_k": top_k,
                    "tokens": list(all_tokens), "chunk_start": chunk_start,
                    "text": text_before, "seq": seq,
                    "key": key_base, "key_splits": n_splits,
                    # tokens[-1] is the un-ingested pending token
                    "spec": bool(spec_on and pending is not None and not stop),
                    # the slot margin a resume replays its decisions from
                    "spec_slots": (new_bucket - slots_used) if spec_cap else None}

        try:
            if resume is not None:
                # adopt the orphan in this journal before emitting anything:
                # a crash before the next chunk must leave a tail here too
                if journaling:
                    jr.append(_snapshot(decoder._emitted))
                # the prefix tokens still radix-resident here (a side-effect
                # free probe; the dense re-prefill does not read them)
                warm = 0
                if self.radix is not None:
                    ids_r, pads = _right_aligned_rows(prompt_ids, prompt_mask)
                    warm = self.radix.peek(P, int(pads[0]), ids_r[0])
                engine_timeline.note_resume(tokens=len(all_tokens), prefill_ms=dt * 1000.0,
                                            warm_tokens=warm)
                delta = decoder.push(all_tokens)
                if delta:  # the journalled last chunk again, at its seq
                    yield delta
                    seq += 1
            while len(all_tokens) < max_new_tokens and not stop:
                gen = self._chunk_generator(base, n_splits, carrier)
                n_splits += 1
                left = max_new_tokens - len(all_tokens)
                if spec_on and new_bucket - slots_used < S + left - (pending is None):
                    # no room for a worst-case round and a plain finish: leave
                    # speculation for good (one row: the margin only shrinks)
                    if pending is not None:
                        with self._lock:
                            t1 = time.perf_counter()
                            with torch.inference_mode():
                                cache, logits, pos, done, kv_valid = carrier.ingest(
                                    self.params, self.model_cfg,
                                    (cache, logits, pos, done, kv_valid), pending,
                                    "lm.ingest_pending[B=1]")
                            dt1 = time.perf_counter() - t1
                            decode_s += dt1
                        dispatch_ledger.note_dispatch("lm.ingest_pending[B=1]", dt1)
                        slots_used += 1
                        pending = None
                    spec_on = False
                if spec_on:
                    draft_params, dcfg = self._draft
                    state = (cache, logits, pos, done, kv_valid)
                    with self._lock:
                        t1 = time.perf_counter()
                        with torch.inference_mode():
                            first = pending is None
                            if first:
                                # plain → spec: the first token off the carried
                                # logits, what the next plain step would sample
                                state, pending, tok0, c0 = carrier.spec_first(
                                    self.model_cfg, gen, state, temperature, top_k, eos_id,
                                    "lm.spec_first[B=1]")
                                head = [tok0, c0.long()]
                            t_d = time.perf_counter()
                            d_cache, drafts = carrier.draft(
                                draft_params, dcfg, d_cache, state, pending, self.spec_k,
                                f"lm.draft_chunk[P={P},B=1,k={self.spec_k}]")
                            t_v = time.perf_counter()
                            state, pending, out, counted, emitted = carrier.verify(
                                self.params, self.model_cfg, gen, state, pending, drafts,
                                temperature, top_k, eos_id,
                                f"lm.verify_chunk[P={P},B=1,k={self.spec_k}]")
                            cache, logits, pos, done, kv_valid = state
                            # the round's one device -> host fetch
                            host = torch.cat(([h[:, None] for h in head] if first else [])
                                             + [out, counted.long(), emitted[:, None]],
                                             dim=1)[0].cpu().numpy()
                        t_end = time.perf_counter()
                        decode_s += t_end - t1
                    dispatch_ledger.note_dispatch(f"lm.draft_chunk[P={P},B=1,k={self.spec_k}]",
                                                  t_v - t_d)
                    dispatch_ledger.note_dispatch(f"lm.verify_chunk[P={P},B=1,k={self.spec_k}]",
                                                  t_end - t_v)
                    if first:
                        dispatch_ledger.note_dispatch("lm.spec_first[B=1]", t_d - t1)
                    slots_used += S
                    n_emit = int(host[-1])
                    self._spec_proposed += self.spec_k
                    self._spec_accepted += max(0, n_emit - 1)
                    body = host[2:] if first else host
                    pairs = ([(host[0], host[1])] if first else []) + list(
                        zip(body[:n_emit], body[S:S + n_emit]))
                else:
                    c_n = min(chunk, new_bucket - slots_used)
                    if c_n <= 0:
                        break  # unreachable while the margin holds
                    with self._lock:
                        t1 = time.perf_counter()
                        with torch.inference_mode():
                            if c_n == chunk:
                                (cache, logits, pos, done, kv_valid, toks,
                                 counted) = carrier.chunk(
                                    self.params, self.model_cfg, gen, cache, logits, pos,
                                    done, kv_valid, c_n, temperature, top_k, eos_id,
                                    f"lm.decode_chunk[P={P},B=1,chunk={c_n}]")
                            else:  # a shorter last chunk runs eagerly
                                cache, logits, pos, done, toks, counted = gpt_mod.decode_chunk(
                                    self.params, cache, logits, pos, done, kv_valid, gen, c_n,
                                    self.model_cfg, **sampling)
                            host = torch.stack((toks[0], counted[0].to(toks.dtype))).cpu().numpy()
                        dt1 = time.perf_counter() - t1
                        decode_s += dt1
                    dispatch_ledger.note_dispatch(f"lm.decode_chunk[P={P},B=1,chunk={c_n}]", dt1)
                    slots_used += c_n
                    pairs = zip(host[0], host[1])
                # the fetch above: the stream's one device -> host sync
                dispatch_ledger.note_host_sync("LmEngine._generate_stream_impl")
                chunk_start = len(all_tokens)
                for t, c in pairs:
                    if not c:  # EOS (or a slot after it): the stream ends here
                        stop = True
                        break
                    all_tokens.append(int(t))
                    if len(all_tokens) >= max_new_tokens:
                        break
                # journal before the yield: a kill in the yield window
                # replays this chunk at this seq (deduped), never drops it
                if journaling:
                    jr.append(_snapshot(decoder._emitted))
                delta = decoder.push(all_tokens)
                if delta:
                    yield delta
                    seq += 1
            final_delta = decoder.flush(all_tokens)
            if final_delta:
                yield final_delta
        finally:
            # on a normal end and on close (the client went away)
            self._give_carrier(carrier)
            usage.note(tenant, tokens_out=len(all_tokens), kv_row_seconds=decode_s * bb)
            with self._lock:
                self.stats["generate_calls"] += 1
                self.stats["tokens_generated"] += len(all_tokens)
                self.stats["decode_s"] += decode_s

    # ----------------------------------------------------- continuous batch

    def start_session(self, prompts: Sequence[str], max_new_tokens: Sequence[int],
                      temperature=None, top_k=None, tenants=None,
                      task_ids=None) -> "BatchSession":
        """Open a chunked batch decode that new requests can join at chunk
        boundaries: drive it with `session.step()`, admit with
        `session.admit()` or `prepare_admit` + `splice`, and `close()` it
        when done with it. `tenants` (one per
        prompt) routes the usage ledger; `task_ids` are taken as the JAX
        engine takes them: with a journal attached, each row with one
        journals a resume snapshot at every chunk boundary."""
        return BatchSession(self, prompts, max_new_tokens, temperature, top_k,
                            tenants=tenants, task_ids=task_ids)

    def kv_rows_allocated(self) -> int:
        """Batch rows allocated across live sessions (the
        `lm.kv_rows_allocated` gauge), for admission decisions."""
        return sum(s.bb for s in self._live_sessions())

    def kv_row_counts(self) -> tuple:
        """(live, allocated) decode rows across live sessions, in one pass.
        Under the paged layout "allocated" counts the rows holding pages
        (a finished row returns its pages at once), so the stranded gap of
        dense slabs reads 0 there."""
        sessions = self._live_sessions()
        live = sum(sum(1 for r in s.rows if r is not None) for s in sessions)
        if self.pool is not None:
            return live, sum(s.rows_holding_pages() for s in sessions)
        return live, sum(s.bb for s in sessions)

    def pages_reserved(self) -> int:
        """Pages live sessions may still claim for rows already admitted
        (each row's worst-case remaining decode blocks; 0 on the dense
        layout). Admission leaves this many free or evictable pages
        untouched, or a session could hit `PoolExhausted` mid-decode."""
        return sum(s.pages_reserved() for s in self._live_sessions())

    def _pages_needed(self, n_rows: int, prompts=None, max_new_tokens=None) -> int:
        """Fresh pages `n_rows` admissions need. Without prompts, the worst
        case at the largest usable (prompt, new) bucket pair; with them,
        the exact quote: each prompt encoded, bucketed and radix-matched,
        and the blocks already committed for its prefix cost nothing."""
        cfg = self.config
        page = cfg.kv_page_tokens
        if prompts is None:
            return max(1, int(n_rows)) * -(-self._largest_span() // page)
        wants = (list(max_new_tokens) if max_new_tokens is not None
                 else [max(cfg.new_token_buckets)] * len(prompts))
        bos = getattr(self.tokenizer, "bos_id", 0)
        total = 0
        for prompt, want in zip(prompts, wants):
            new_b = _round_up(int(want), cfg.new_token_buckets)
            cap = self.model_cfg.max_position_embeddings - new_b
            avail = [b for b in cfg.prompt_buckets if b <= cap] or [cap]
            ids = self.tokenizer.encode(prompt or "", 1 << 30)[-avail[-1]:] or [bos]
            P = _round_up(len(ids), avail)
            hit = 0
            if self.radix is not None:
                ids_r = np.zeros(P, np.int32)
                ids_r[P - len(ids):] = ids
                hit = self.radix.match(P, P - len(ids), ids_r).blocks
            total += -(-(P + new_b) // page) - hit
        return total

    def can_admit(self, n_rows: int = 1, max_kv_rows: int = 0, prompts=None,
                  max_new_tokens=None) -> bool:
        """May `n_rows` more decode rows start? Under the paged layout the
        pages come first: the fresh pages they need (the worst case, or the
        exact quote with radix hits deducted when `prompts` and
        `max_new_tokens` are given) against the free and evictable pages
        less those admitted rows may still claim. On a card, the fresh
        device bytes they may need (`_admit_bytes_forecast`) must fit its
        free bytes, else `lm.admit_hbm_rejects` counts one refusal; on the
        CPU, which keeps no memory statistics, that forecast is skipped.
        Then the allocated rows must stay within `max_kv_rows` (<= 0: no
        cap)."""
        n = max(1, int(n_rows))
        if self.pool is not None:
            need = self._pages_needed(n, prompts, max_new_tokens)
            with self.pool.lock:
                avail = self.pool.pages_free + self.pool.pages_retained - self.pages_reserved()
            if need > avail:
                return False
        headroom = self.hbm_headroom_bytes()
        if headroom is not None and self._admit_bytes_forecast(n) > headroom:
            metrics.inc("lm.admit_hbm_rejects")
            return False
        if max_kv_rows <= 0:
            return True
        return self.kv_rows_allocated() + n <= max_kv_rows

    def _admit_bytes_forecast(self, n_rows: int) -> int:
        """Fresh device bytes `n_rows` admissions may need, as JAX's: on the
        dense layout each row's cache at the largest usable (prompt, new)
        bucket pair (the int8 cache's scale planes included; paged rows
        take pages of the resident pool, no fresh bytes), plus the largest
        `temp_bytes` of an lm.* executable in the dispatch ledger
        (`obs/hbm.peak_temp_bytes`: a capture's graph pool growth; 0 before
        the first, and on the CPU)."""
        mc = self.model_cfg
        per_row = 0
        if self.pool is None:
            slots = mc.num_layers * self._largest_span() * mc.kv_heads
            if mc.kv_quant == "int8":
                per_row = 2 * slots * (mc.head_dim + 4)  # int8 codes, float32 scales
            else:
                per_row = 2 * slots * mc.head_dim * torch_dtype(mc.dtype).itemsize
        return per_row * n_rows + peak_temp_bytes("lm.")

    def update_params(self, params) -> None:
        """Swap in new parameters (an online fine-tune's sync): placed as at
        load, then copied leaf by leaf into the tensors the engine already
        holds (a quantized leaf's codes and scales), so every decode carrier
        and prefill executable replays on the new weights with no new
        capture, as JAX's executables take the parameters as arguments. The
        copy holds the engine lock and `_stage_lock`, so it is enqueued
        after every decode and prefill replay enqueued before it and before
        every one after it (one stream orders them). A running stream or
        session takes the new weights at its next chunk; its cache from the
        old parameters stays valid context. A tree whose structure, shapes
        or dtypes differ from the engine's raises ValueError. The engine's
        tensors are written: an engine built on a caller's tensors already
        in its compute dtype on its device (`params=`) holds those, and a
        sync writes them too. Committed prefix pages and their logits are
        stale under the new weights: the radix cache is cleared (live rows
        keep their own pages).

        A tree already placed on the engine's mesh (a TP fine-tune's
        masters, `train/online.py`) is copied shard for shard into the
        engine's shards, each cast to the compute dtype on the copy: no
        gather and no new placement. A quantized TP engine gathers it and
        places it as at load (a row-split kernel's scales span its
        shards)."""
        shard_for_shard = (self.mesh is not None and mesh_of(params) is self.mesh
                           and self.config.quantize == "none")
        if shard_for_shard:
            placed = params
        else:
            if mesh_of(params) is not None:
                params = gather_tree(params, self.device)
            placed = self._place_params(params)
        if quant.tree_map(lambda _: 0, placed) != quant.tree_map(lambda _: 0, self.params):
            raise ValueError("update_params: the tree's keys or lengths differ from the engine's")
        pairs = []  # leaves by sorted keys: a tree's dict order need not be the engine's
        for a, b in zip(tree_leaves(self.params), tree_leaves(placed)):
            if shard_for_shard and getattr(a, "spec", None) != getattr(b, "spec", None):
                raise ValueError(f"update_params: a leaf placed on {getattr(b, 'spec', None)}, "
                                 f"the engine's on {getattr(a, 'spec', None)}")
            for x, y in zip(leaf_tensors(a), leaf_tensors(b), strict=True):
                cast_ok = shard_for_shard and x.is_floating_point() and y.is_floating_point()
                if x.shape != y.shape or (x.dtype != y.dtype and not cast_ok):
                    raise ValueError(f"update_params: {tuple(y.shape)} {y.dtype} does not fit "
                                     f"the engine's {tuple(x.shape)} {x.dtype}")
                pairs.append((x, y))
        with self._lock, self._stage_lock, torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
        if self.radix is not None:
            self.radix.clear()

    def _paged_cache(self, table, length):
        """The paged cache over the pool at a carrier's device page table
        (`table`, a tuple of one a shard under TP): a `PagedKVCache`, or a
        `gpt.TPCache` of one a tensor shard, each on its shard's arrays
        and copy of the table."""
        shards = tuple(PagedKVCache(*arrays, t, length)
                       for arrays, t in zip(self.pool.shards, _tables(table), strict=True))
        return shards[0] if self.mesh is None else gpt_mod.TPCache(shards, length)

    def _scatter_staged(self, staged, scatter: torch.Tensor, prompt_width: int) -> None:
        """A staged prefill's rows into the pool through the scatter table
        (`kv/paged.scatter_prompt`), each tensor shard's staged cache into
        its own arrays under TP."""
        stageds = staged.shards if isinstance(staged, gpt_mod.TPCache) else (staged,)
        for arrays, st in zip(self.pool.shards, stageds, strict=True):
            paged_mod.scatter_prompt(*arrays, st, scatter, prompt_width)

    def warmup(self, new_bucket: Optional[int] = None) -> None:
        """Run the hot (prompt, new) shape once, so the first request does
        not pay the decode graph's capture, the kernel build, library
        loading and allocator growth."""
        self.generate("warmup", new_bucket or self.config.new_token_buckets[0])


def _tables(table) -> tuple:
    """A carrier's device page table as a tuple of one a pool shard."""
    return table if isinstance(table, tuple) else (table,)


def _norm_tenants(tenants, n: int) -> list:
    """Per-row tenants of length n (the default lane where unnamed)."""
    if tenants is None:
        return [DEFAULT_TENANT] * n
    if len(tenants) != n:
        raise ValueError(f"tenants list length {len(tenants)} != {n}")
    return [t or DEFAULT_TENANT for t in tenants]


def _real_token_rows(prompt_ids: np.ndarray, prompt_mask: np.ndarray, n: int) -> list:
    """The first n rows' real token ids, padding stripped (the prefix
    probe's input)."""
    return [prompt_ids[i, :int(prompt_mask[i].sum())].tolist() for i in range(n)]


def _right_aligned_rows(prompt_ids: np.ndarray, prompt_mask: np.ndarray) -> tuple:
    """Host mirror of `gpt._align_prompt`'s token layout: (ids_r [bb, P]
    with 0 at the left-padding slots, pads [bb]). The radix cache keys
    pages by exactly the layout the staged prefill writes."""
    bb, P = prompt_ids.shape
    ids_r = np.zeros((bb, P), np.int32)
    pads = np.empty(bb, np.int64)
    for i in range(bb):
        ln = int(prompt_mask[i].sum())
        pads[i] = P - ln
        if ln:
            ids_r[i, P - ln:] = prompt_ids[i, :ln]
    return ids_r, pads


class _SessionRow:
    """One request in a session: its tag, budget, tokens so far, the
    tenant it bills, when its prefill started (`created`: a spliced row's
    TTFT counts its own prefill and wait), when its first token reached
    the host, and whether its whole prompt was a radix hit (its prefill
    skipped). `task_id` keys the row's journal snapshots (a row without
    one is not journalled) and `prompt_ids` are its exact post-trim prompt
    ids, what a resume re-prefills."""

    __slots__ = ("tag", "want", "tokens", "tenant", "created", "first_tok", "radix_hit",
                 "task_id", "prompt_ids")

    def __init__(self, tag: int, want: int, tenant: str = DEFAULT_TENANT,
                 created: Optional[float] = None, radix_hit: bool = False,
                 task_id: Optional[str] = None, prompt_ids=None):
        self.tag = tag
        self.want = want
        self.tokens: list = []
        self.task_id = task_id
        self.prompt_ids = prompt_ids
        self.tenant = tenant
        self.created = time.perf_counter() if created is None else created
        self.first_tok: Optional[float] = None
        self.radix_hit = radix_hit


class BatchSession:
    """A running chunked batch decode that requests can join at chunk
    boundaries (continuous batching).

    The session decodes in `stream_chunk`-step chunks (or, with a drafter,
    draft + verify rounds while the slot margin allows) and, between them,
    splices newly prefilled rows into free rows (the power-of-two batch
    bucket's padding rows, or rows whose request finished) through
    `gpt.merge_rows`: an admitted request's output is exactly its
    standalone decode's (gap slots masked, logical positions carried on).

    Under the paged layout the session holds a host page table (the
    authority; the device copy is rebuilt when it changes), maps each row's
    prompt blocks at its start or admission (radix-shared pages retained,
    fresh ones allocated), grows decode blocks lazily before each chunk and
    returns a row's pages the moment it finishes or is cancelled. Its cache
    is a view built per call over the engine's pool.

    Threads: device work runs under the engine lock and inside
    `torch.inference_mode()` (thread-local, so entered by each method);
    `prepare_admit` prefills without the lock, on whatever thread calls
    it, while `step()` decodes on another. On a card the prepared state
    carries a CUDA event recorded after its prefills on the preparing
    thread's stream; `splice` makes its own stream wait on it and marks the
    prepared tensors as used there before it writes. A splice writes the
    shared pool only at the newcomers' fresh pages: shared radix pages,
    which other sessions are reading, take the scratch page in the scatter
    table. Page bookkeeping runs under the pool lock. The rest of the host
    bookkeeping has one caller at a time (GenBatcher calls
    `splice`/`step`/`cancel_tag` in turn).
    """

    def __init__(self, lm: LmEngine, prompts: Sequence[str], max_new_tokens: Sequence[int],
                 temperature=None, top_k=None, tenants=None, task_ids=None):
        cfg = lm.config
        self.lm = lm
        n = len(prompts)
        if n != len(max_new_tokens):
            raise ValueError("prompts and max_new_tokens length mismatch")
        # a spec round may burn spec_k + 1 slots for one token: spec_k slots
        # of bucket headroom keep the margin guard's room
        headroom = lm.spec_k if lm._draft is not None else 0
        prompt_ids, prompt_mask, self.new_bucket = lm._prepare_prompts(
            prompts, max(max_new_tokens) + headroom, min_rows=cfg.session_min_rows)
        self.bb, self.P = prompt_ids.shape
        self.chunk = max(1, min(cfg.stream_chunk, self.new_bucket))
        self._temps = lm._norm_sampling_rows(temperature, cfg.temperature, self.bb, n, float)
        self._ks = lm._norm_sampling_rows(top_k, cfg.top_k, self.bb, n, int)
        self._eos = int(getattr(lm.tokenizer, "eos_id", -1))
        row_tenants = _norm_tenants(tenants, n)
        row_task_ids = list(task_ids) if task_ids else [None] * n
        self.rows: list = [_SessionRow(i, min(int(w), self.new_bucket), tenant=row_tenants[i],
                                       task_id=row_task_ids[i],
                                       prompt_ids=prompt_ids[i][prompt_mask[i] > 0].tolist())
                           for i, w in enumerate(max_new_tokens)]
        self._next_tag = n
        self.rows += [None] * (self.bb - n)  # free rows from the batch bucket
        self.steps_done = 0
        self.decode_s = 0.0
        dev = lm.device
        # paged bookkeeping: the host page table (scratch where unmapped),
        # the pages each row holds a refcount on, its mapped block count
        self._paged = lm.pool is not None
        self._plen = prompt_mask.sum(axis=1).astype(np.int64)  # [bb]
        self._row_pages: list = [[] for _ in range(self.bb)]
        self._row_blocks = [0] * self.bb
        if self._paged:
            page = lm.pool.page_tokens
            self._n_blocks = -(-(self.P + self.new_bucket) // page)
            self._prompt_blocks = self.P // page
            self._pt = np.zeros((self.bb, self._n_blocks), np.int64)
            self._pt_dirty = True
        # host-side probes on values in hand: prefix overlap with recent
        # prompts, and each tenant's exact prompt tokens
        share = engine_timeline.prompt_prefix_share(_real_token_rows(prompt_ids, prompt_mask, n))
        for i in range(n):
            usage.note(row_tenants[i], tokens_in=int(prompt_mask[i].sum()))
        # radix match and prompt-page wiring in ONE pool-lock section: a
        # matched page is retained before any alloc of this start could
        # evict it
        matches: list = [None] * self.bb
        skip_prefill = False
        hit_tokens = 0
        if self._paged:
            ids_r, pads = _right_aligned_rows(prompt_ids, prompt_mask)
            pool = lm.pool
            with pool.lock:
                for i in range(n):
                    if lm.radix is not None:
                        matches[i] = lm.radix.match(self.P, int(pads[i]), ids_r[i])
                        for pid in matches[i].pages:
                            pool.retain(pid)
                skip_prefill = lm.radix is not None and n > 0 and all(
                    matches[i].logits is not None for i in range(n))
                for i in range(n):
                    shared = list(matches[i].pages) if matches[i] else []
                    hit_tokens += max(0, len(shared) * pool.page_tokens - int(pads[i]))
                    fresh_n = self._prompt_blocks - len(shared)
                    self._map_prompt(i, shared + (pool.alloc(fresh_n) if fresh_n else []))
            pool.note_hit_tokens(hit_tokens)
        # a session borrows a carrier until it is closed: its cache (dense)
        # takes the prefill's prompt slots, or its page table (paged) is the
        # one the chunks read; its generator is the session's, and full
        # chunks replay its graph
        self._closed = False
        self._carrier = lm._take_carrier(self.bb, self.P, self.new_bucket, paged=self._paged)
        with lm._lock:
            t0 = time.perf_counter()
            self._gen = self._carrier.generator(lm._draw_seed())
            with torch.inference_mode():
                if skip_prefill:
                    # every real row's whole prompt is committed pages and
                    # stored logits: no prefill, the row state is restored
                    for i in range(n):
                        self.rows[i].radix_hit = True
                    logits = np.zeros((self.bb, lm.model_cfg.vocab_size), np.float32)
                    kvv = np.zeros((self.bb, self.P + self.new_bucket), bool)
                    kvv[:, self.P:] = True
                    for i in range(n):
                        logits[i] = matches[i].logits
                        kvv[i, int(pads[i]):self.P] = True
                    self._cache = None
                    self._logits = torch.from_numpy(logits).to(dev)
                    self._kv_valid = torch.from_numpy(kvv).to(dev)
                    self._pos = torch.from_numpy(self._plen.copy()).to(dev)
                else:
                    adopt = None
                    if self._paged:
                        # the staged prefill into the pool: each real row's
                        # fresh prompt blocks only, bit for bit
                        scatter = np.zeros((self.bb, self._prompt_blocks), np.int64)
                        for i in range(n):
                            nsh = matches[i].blocks if matches[i] else 0
                            scatter[i, nsh:] = self._pt[i, nsh:self._prompt_blocks]
                        scatter = torch.from_numpy(scatter).to(dev)

                        def adopt(staged):
                            lm._scatter_staged(staged, scatter, self.P)
                    self._cache, self._logits, self._kv_valid, self._pos = lm._prefill(
                        lm.params, prompt_ids, prompt_mask, self.new_bucket,
                        cache=self._carrier.cache0, adopt=adopt)
                    lm._prefill_shapes.add((self.bb, self.P, self.new_bucket))
                self._done = torch.zeros((self.bb,), dtype=torch.bool, device=dev)
            prefill_s = time.perf_counter() - t0
            self.decode_s += prefill_s
            lm.stats["sessions"] = lm.stats.get("sessions", 0) + 1
        if not skip_prefill:
            dispatch_ledger.note_dispatch(
                f"lm.prefill[P={self.P},B={self.bb},new={self.new_bucket}]", prefill_s)
        if self._paged and lm.radix is not None and n and not skip_prefill:
            # commit the new prompt blocks and their logits for the next
            # admission with this prefix (one [bb, V] fetch per start)
            self._commit(range(n), ids_r, pads, self._logits.cpu().numpy(), range(n))
            dispatch_ledger.note_host_sync("BatchSession.__init__")
        # the drafter: a dense prefill at the same geometry, also after a
        # full radix hit (it has no radix); a failure decodes plain
        self._d_cache = None
        self._pending = None  # [bb] on the device; set in the spec state
        self._spec_on = lm._draft is not None
        self._spec_rounds = 0
        self._spec_ema = None  # EMA of per-round acceptance
        if self._spec_on:
            try:
                with lm._lock:
                    t1 = time.perf_counter()
                    with torch.inference_mode():
                        # into the carrier's drafter cache, which the round
                        # executables are bound to
                        self._d_cache = lm._draft_prefill(
                            prompt_ids, prompt_mask, self.new_bucket,
                            cache=self._carrier.draft_cache(lm._draft[1]))
                    dp_s = time.perf_counter() - t1
                    self.decode_s += dp_s
                dispatch_ledger.note_dispatch(
                    f"lm.draft_prefill[P={self.P},B={self.bb},new={self.new_bucket}]", dp_s)
            except Exception:
                log.warning("draft prefill failed: the session decodes plain", exc_info=True)
                self._spec_on = False
                self._d_cache = None
        engine_timeline.note_admit(
            rows=n, prefill_ms=prefill_s * 1000.0, prefix_share=share, kind="start",
            hit_tokens=hit_tokens if self._paged else None,
            prompt_tokens=int(self._plen[:n].sum()) if self._paged else None)
        with lm._sessions_lock:  # the KV gauges see live sessions
            lm._sessions.add(self)
        # end of the last device work: step() splits chunk-to-chunk wall
        # into device work and host time from it
        self._last_step_end = time.perf_counter()

    # ------------------------------------------------------- paged KV state

    def _map_prompt(self, i: int, pages: list) -> None:
        """Row i's prompt blocks map `pages` (its refcounts already held).
        The caller holds the pool lock."""
        self._pt[i, :self._prompt_blocks] = pages
        self._row_pages[i] = pages
        self._row_blocks[i] = self._prompt_blocks
        self._pt_dirty = True

    def _commit(self, rows, ids_r, pads, logits_host, src_rows) -> None:
        """Commit rows' prompt blocks and last-token logits to the radix
        cache (row i's prompt is the prepared row src_rows[k] of
        ids_r/pads/logits_host)."""
        with self.lm.pool.lock:
            for i, j in zip(rows, src_rows):
                self.lm.radix.commit(self.P, int(pads[j]), ids_r[j],
                                     [int(p) for p in self._pt[i, :self._prompt_blocks]],
                                     logits_host[j])

    def rows_holding_pages(self) -> int:
        """Rows mapping at least one pool page: the paged layout's
        allocated rows (a finished row returns its pages at once)."""
        return sum(1 for pages in self._row_pages if pages)

    def pages_reserved(self) -> int:
        """Pages this session's live rows may still claim (every row
        decoding to the session's last slot); 0 on the dense layout."""
        if not self._paged:
            return 0
        return sum(self._n_blocks - self._row_blocks[i]
                   for i, r in enumerate(self.rows) if r is not None)

    def page_occupancy(self) -> tuple:
        """(live tokens, mapped page slots) over live rows, the numbers
        behind kv.page_fragmentation_pct; a shared page counts once per
        row mapping it."""
        if not self._paged:
            return 0, 0
        page = self.lm.pool.page_tokens
        toks = slots = 0
        for i, r in enumerate(self.rows):
            if r is not None:
                toks += int(self._plen[i]) + len(r.tokens)
                slots += self._row_blocks[i] * page
        return toks, slots

    def _build_cache(self):
        """The paged cache view for the next device call (`LmEngine.
        _paged_cache`): the pool's tensors, the carrier's device page table
        (the host one's bytes copied in, enqueued after every call that
        read it before, when the host one changed; into every shard's copy
        under TP) and its length, P + steps_done."""
        table = self._carrier.page_table
        if self._pt_dirty:
            host = torch.from_numpy(self._pt.copy())
            for t in _tables(table):
                t.copy_(host, non_blocking=True)
            self._pt_dirty = False
        return self.lm._paged_cache(table, self.P + self.steps_done)

    def _ensure_decode_blocks(self, slots: int) -> None:
        """Lazy page growth: before a chunk every live row maps enough
        blocks for cache slots [0, P + steps_done + slots). Rows that end
        early never claim their tail blocks."""
        pool = self.lm.pool
        need = min(self._n_blocks, -(-(self.P + self.steps_done + slots) // pool.page_tokens))
        with pool.lock:
            for i, r in enumerate(self.rows):
                while r is not None and self._row_blocks[i] < need:
                    pid = pool.alloc(1)[0]
                    self._pt[i, self._row_blocks[i]] = pid
                    self._row_pages[i].append(pid)
                    self._row_blocks[i] += 1
                    self._pt_dirty = True

    def _release_row_pages(self, i: int) -> None:
        """Return row i's pages the moment it finishes or is cancelled:
        committed ones to the pool's retained set, private ones to the free
        list; its page-table row points at scratch again."""
        if not self._paged or not self._row_pages[i]:
            return
        with self.lm.pool.lock:
            for pid in self._row_pages[i]:
                self.lm.pool.release(pid)
        self._row_pages[i] = []
        self._row_blocks[i] = 0
        self._pt[i, :] = paged_mod.SCRATCH_PAGE
        self._pt_dirty = True

    # ------------------------------------------------------------ admission

    def capacity(self) -> int:
        return sum(1 for r in self.rows if r is None)

    def remaining_steps(self) -> int:
        return self.new_bucket - self.steps_done

    def round_slots(self) -> int:
        """Decode slots the next step() may use: one chunk, or a spec
        round's spec_k + 1 if larger."""
        if self._spec_on:
            return max(self.chunk, self.lm.spec_k + 1)
        return self.chunk

    def done(self) -> bool:
        return all(r is None for r in self.rows) or self.remaining_steps() <= 0

    def can_admit(self, prompt: str, max_new: int, lookahead_chunks: int = 0) -> bool:
        """A newcomer may join if a row is free, its budget fits the steps
        the session has left after `lookahead_chunks` more rounds (those
        that decode while its prefill runs) and, in the spec state, the
        slot that folding the pending token in takes; its prompt fits the
        session's prompt bucket untrimmed; and, paged, its row's whole span
        less its radix-shared blocks fits the free and evictable pages not
        reserved by admitted rows."""
        debt = 1 if self._pending is not None else 0
        if (self.capacity() == 0 or int(max_new) > self.remaining_steps() - debt
                - lookahead_chunks * self.round_slots()):
            return False
        enc = self.lm.tokenizer.encode(prompt or "", self.P + 1)
        if len(enc) > self.P:
            return False
        if self._paged:
            pool, radix = self.lm.pool, self.lm.radix
            enc = enc or [getattr(self.lm.tokenizer, "bos_id", 0)]
            ids_r = np.zeros(self.P, np.int32)
            ids_r[self.P - len(enc):] = enc
            with pool.lock:
                hit = radix.match(self.P, self.P - len(enc), ids_r).blocks if radix else 0
                avail = pool.pages_free + pool.pages_retained - self.lm.pages_reserved()
            if self._n_blocks - hit > avail:
                return False
        return True

    @staticmethod
    def _admission_rows(k: int) -> int:
        """Rows an admission prefill pads to (a power of two): one source
        for prepare_admit and prefill_warm."""
        return 1 << (k - 1).bit_length() if k > 1 else 1

    def prefill_warm(self, k: int) -> bool:
        """Whether admitting k newcomers prefills at a shape a session start
        or an admission has already run, as JAX's compiled shapes: its
        executable is captured (its first run pays the capture) and has not
        been dropped since (`_trim_prefills`)."""
        return (self._admission_rows(k), self.P, self.new_bucket) in self.lm._prefill_shapes

    def prepare_admit(self, prompts: Sequence[str], max_new_tokens: Sequence[int],
                      temperature=None, top_k=None, tenants=None, task_ids=None) -> dict:
        """Admission, phase 1: tokenize and prefill the newcomers at the
        session's prompt bucket WITHOUT the engine lock, so the prefill does
        not stall the running chunk; with a drafter, its rows too. Paged,
        a radix probe (no refcounts taken) skips the target prefill when
        every newcomer is a full hit; `splice` matches again under the pool
        lock. A concurrent `update_params` lands wholly before or after this
        prefill's replay (it takes `_stage_lock` too).
        Returns the prepared state for `splice`; the session is not
        touched."""
        cfg, lm = self.lm.config, self.lm
        t_enter = time.perf_counter()  # the spliced rows' TTFT origin
        k = len(prompts)
        bb2 = self._admission_rows(k)
        tok = lm.tokenizer
        bos = getattr(tok, "bos_id", 0)
        ids = np.full((bb2, self.P), getattr(tok, "pad_id", 0), np.int32)
        mask = np.zeros((bb2, self.P), np.int32)
        for j, prompt in enumerate(prompts):
            enc = tok.encode(prompt or "", 1 << 30)[-self.P:] or [bos]
            ids[j, :len(enc)] = enc
            mask[j, :len(enc)] = 1
        ids[k:, 0] = bos  # padding rows: a one-token prompt
        mask[k:, 0] = 1
        share = engine_timeline.prompt_prefix_share(_real_token_rows(ids, mask, k))
        n_tokens = [int(mask[j].sum()) for j in range(k)]
        paged = None
        skip = False
        if self._paged:
            ids_r, pads = _right_aligned_rows(ids, mask)
            if lm.radix is not None:
                with lm.pool.lock:
                    skip = k > 0 and all(lm.radix.match(self.P, int(pads[j]), ids_r[j]).logits
                                         is not None for j in range(k))
            paged = {"ids_r": ids_r, "pads": pads}
        params = lm.params
        t0 = time.perf_counter()
        cache_b = logits_b = kv_valid_b = pos_b = d_cache_b = None
        with torch.inference_mode():
            if not skip:
                # replayed under the prefill executables' own lock, never
                # the engine's; the rows come back as a clone
                cache_b, logits_b, kv_valid_b, pos_b = lm._prefill(params, ids, mask,
                                                                   self.new_bucket)
            if self._spec_on and self._d_cache is not None:
                # the drafter's rows, also for a full radix hit
                d_cache_b = lm._draft_prefill(ids, mask, self.new_bucket)
            event = None
            if lm.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(lm.device))
        if not skip:
            lm._prefill_shapes.add((bb2, self.P, self.new_bucket))
        prefill_s = time.perf_counter() - t0
        if not skip:
            dispatch_ledger.note_dispatch(f"lm.prefill[P={self.P},B={bb2},new={self.new_bucket}]",
                                          prefill_s)
        return {"k": k, "bb2": bb2, "cache": cache_b, "logits": logits_b,
                "kv_valid": kv_valid_b, "pos": pos_b, "d_cache": d_cache_b, "event": event,
                "paged": paged, "max_new": [int(w) for w in max_new_tokens],
                "temps": lm._norm_sampling_rows(temperature, cfg.temperature, bb2, k, float),
                "ks": lm._norm_sampling_rows(top_k, cfg.top_k, bb2, k, int),
                "tenants": _norm_tenants(tenants, k), "n_tokens": n_tokens,
                "task_ids": list(task_ids) if task_ids else [None] * k,
                "prompt_row_ids": [ids[j, :n_tokens[j]].tolist() for j in range(k)],
                "prefix_share": share, "t_enter": t_enter, "prefill_s": prefill_s}

    def _take_rows(self, prep: dict) -> tuple:
        """The host half of a splice: newcomer j takes the next free row
        if its budget still fits and, paged, its pages can be mapped (a
        fresh radix match under the pool lock, its shared pages retained,
        fresh ones allocated; a full-hit prep whose hit has since been
        evicted has nothing to write its pages from and is refused).
        → (row_map, tags, {row: (j, shared blocks, full-hit logits)}, hit
        tokens)."""
        pg, pool, radix = prep["paged"], self.lm.pool, self.lm.radix
        free = [i for i, r in enumerate(self.rows) if r is None]
        row_map = np.full((self.bb,), -1, np.int64)
        tags, taken, hit_tokens = [], {}, 0
        lock = pool.lock if self._paged else contextlib.nullcontext()
        with lock:
            for j in range(prep["k"]):
                if len(taken) >= len(free) or prep["max_new"][j] > self.remaining_steps():
                    tags.append(None)
                    continue
                i = free[len(taken)]
                if self._paged:
                    m = radix.match(self.P, int(pg["pads"][j]), pg["ids_r"][j]) if radix else None
                    if prep["cache"] is None and (m is None or m.logits is None):
                        tags.append(None)
                        continue
                    shared = list(m.pages) if m is not None else []
                    for pid in shared:  # before the alloc, which could evict them
                        pool.retain(pid)
                    need = self._prompt_blocks - len(shared)
                    if not pool.can_alloc(need):
                        for pid in shared:
                            pool.release(pid)
                        tags.append(None)
                        continue
                    self._map_prompt(i, shared + (pool.alloc(need) if need else []))
                    hit_tokens += max(0, len(shared) * pool.page_tokens - int(pg["pads"][j]))
                taken[i] = ((j, len(shared), m and m.logits) if self._paged
                            else (j, 0, None))
                row_map[i] = j
                self.rows[i] = _SessionRow(self._next_tag, prep["max_new"][j],
                                           tenant=prep["tenants"][j], created=prep["t_enter"],
                                           radix_hit=self._paged and prep["cache"] is None,
                                           task_id=prep["task_ids"][j],
                                           prompt_ids=prep["prompt_row_ids"][j])
                usage.note(self.rows[i].tenant, tokens_in=prep["n_tokens"][j])
                tags.append(self._next_tag)
                self._next_tag += 1
                self._temps[i] = prep["temps"][j]
                self._ks[i] = prep["ks"][j]
        if self._paged:
            pool.note_hit_tokens(hit_tokens)
        return row_map, tags, taken, hit_tokens

    def splice(self, prep: dict) -> list:
        """Admission, phase 2: merge prepared rows into free rows at this
        chunk boundary, under the lock (row copies, and paged the fresh
        prompt blocks' scatter; no prefill). In the spec state the pending
        token is first folded into both caches (one slot), since newcomers
        carry none. Returns a tag per newcomer, or None where it no longer
        fits: chunks decoded since `prepare_admit` shrank the budget
        (truncating would break standalone equivalence), or, paged, its
        pages cannot be had; the caller queues it again."""
        self._check_open()
        if prep["k"] and self._pending is not None:
            self._to_plain()
        row_map, tags, taken, hit_tokens = self._take_rows(prep)
        if not taken:
            # a refused admission still paid its prefill: keep it in the time
            with self.lm._lock:
                self.decode_s += prep["prefill_s"]
            return tags
        lm, dev, bb2 = self.lm, self.lm.device, prep["bb2"]
        with lm._lock:
            t0 = time.perf_counter()
            with torch.inference_mode():
                if prep["event"] is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(prep["event"])
                    for part in (prep["cache"], prep["d_cache"],
                                 (prep["logits"], prep["pos"], prep["kv_valid"])):
                        for t in part or ():
                            if isinstance(t, torch.Tensor):
                                t.record_stream(stream)
                done_b = torch.zeros((bb2,), dtype=torch.bool, device=dev)
                logits_b, pos_b, kv_valid_b = prep["logits"], prep["pos"], prep["kv_valid"]
                if self._paged:
                    pg = prep["paged"]
                    scatter = np.zeros((bb2, self._prompt_blocks), np.int64)
                    for i, (j, nsh, _) in taken.items():
                        # fresh (post-fork) blocks only; others on scratch
                        scatter[j, nsh:] = self._pt[i, nsh:self._prompt_blocks]
                    if prep["cache"] is None:
                        # a full-hit splice: the row state restored on the host
                        ln = np.zeros((bb2, lm.model_cfg.vocab_size), np.float32)
                        pn = np.zeros((bb2,), np.int64)
                        kn = np.zeros((bb2, self.P + self.new_bucket), bool)
                        kn[:, self.P:] = True
                        for j, _, hit_logits in taken.values():
                            pad = int(pg["pads"][j])
                            ln[j] = hit_logits
                            pn[j] = self.P - pad
                            kn[j, pad:self.P] = True
                        logits_b, pos_b, kv_valid_b = (torch.from_numpy(a).to(dev)
                                                       for a in (ln, pn, kn))
                    cache_a = self._build_cache()
                    cache_b = (prep["cache"], torch.from_numpy(scatter).to(dev),
                               self._carrier.page_table)
                else:
                    cache_a, cache_b = self._cache, prep["cache"]
                (cache, self._logits, self._pos, self._done,
                 self._kv_valid) = gpt_mod.merge_rows(
                    cache_a, self._logits, self._pos, self._done, self._kv_valid, cache_b,
                    logits_b, pos_b, done_b, kv_valid_b, row_map, prompt_width=self.P)
                if not self._paged:
                    self._cache = cache
                if self._d_cache is not None:
                    if prep["d_cache"] is not None:
                        # the drafter's rows, same row_map; gap validity rides
                        # the shared kv_valid merge_rows just masked
                        gpt_mod.merge_cache_rows(self._d_cache, prep["d_cache"], row_map)
                    else:
                        # prepared before the drafter failed: speculating over
                        # rows without drafter content would propose garbage
                        self._spec_on = False
                        self._d_cache = None
            merge_s = time.perf_counter() - t0
            self.decode_s += merge_s + prep["prefill_s"]
            lm.stats["admitted"] = lm.stats.get("admitted", 0) + len(taken)
        dispatch_ledger.note_dispatch(f"lm.merge_rows[P={self.P},B={self.bb}]", merge_s)
        if self._paged and lm.radix is not None and prep["cache"] is not None:
            pg = prep["paged"]
            self._commit(list(taken), pg["ids_r"], pg["pads"], prep["logits"].cpu().numpy(),
                         [j for j, _, _ in taken.values()])
            dispatch_ledger.note_host_sync("BatchSession.splice")
        engine_timeline.note_admit(
            rows=len(taken), prefill_ms=prep["prefill_s"] * 1000.0,
            prefix_share=prep["prefix_share"], kind="splice",
            hit_tokens=hit_tokens if self._paged else None,
            prompt_tokens=(sum(prep["n_tokens"][j] for j, _, _ in taken.values())
                           if self._paged else None))
        return tags

    def admit(self, prompts: Sequence[str], max_new_tokens: Sequence[int], temperature=None,
              top_k=None, tenants=None, task_ids=None) -> list:
        """`prepare_admit` and `splice` back to back (no chunk between
        them, so none is refused for its budget): the caller checks
        `can_admit` first. Returns each newcomer's tag in step() results."""
        tags = self.splice(self.prepare_admit(prompts, max_new_tokens, temperature=temperature,
                                              top_k=top_k, tenants=tenants, task_ids=task_ids))
        if None in tags:
            raise ValueError(f"admit() of {len(tags)} rows beyond capacity(): tags {tags}")
        return tags

    def cancel_tag(self, tag: int) -> bool:
        """Abort one running request (its client went away): its row and,
        paged, its pages free now, admissible at the next chunk boundary,
        `lm.kv_rows_active` stops counting it, and a session whose rows
        are all cancelled reads done(). Its tokens are dropped, not
        published. False when the tag is not live (it finished first)."""
        for i, row in enumerate(self.rows):
            if row is not None and row.tag == tag:
                self.rows[i] = None
                self._release_row_pages(i)
                usage.note(row.tenant, tokens_out=len(row.tokens))
                engine_timeline.note_cancel()
                if self.lm.journal is not None and row.task_id:
                    # a cancelled row is terminal: it must never come back
                    # as a resume after a later worker death
                    self.lm.journal.mark_done(row.task_id)
                with self.lm._lock:
                    self.lm.stats["cancelled"] = self.lm.stats.get("cancelled", 0) + 1
                    self.lm.stats["tokens_generated"] += len(row.tokens)
                    # a fully cancelled session never reaches _finish: its
                    # time goes with its tokens, or tok/s would inflate
                    self.lm.stats["decode_s"] += self.decode_s
                    self.decode_s = 0.0
                return True
        return False

    # --------------------------------------------------------------- decode

    def step(self) -> list:
        """Decode one chunk, or one draft + verify round when a drafter is
        attached and the slot margin allows it → [(tag, text), ...] for
        every request that finished in it (eos, its own budget or the
        session's). The choice is made again at every boundary. Under
        `guard_oom("lm.batch_step")`: a device OOM leaves its postmortem
        and is raised to the caller, which fails the affected requests."""
        self._check_open()
        with guard_oom("lm.batch_step"):
            if self.done():
                return self._drain_all()
            if self._spec_on and self._d_cache is not None and self._spec_margin_ok():
                return self._step_spec()
            if self._pending is not None:
                self._to_plain()
                if self.done():  # the ingest slot was the session's last
                    return self._drain_all()
            return self._step_plain()

    def close(self) -> None:
        """Retire the session: a dense session's carrier (its cache and
        decode graphs) goes back to the engine's pool for the next borrower
        of its geometry. The owner calls it once it will neither step nor
        splice the session again (`GenBatcher` after its loop; a session
        is also a context manager): a session that is done may still take
        a splice and decode on, so being done does not retire it. A step
        or splice after `close` raises. Idempotent."""
        self._closed = True
        carrier, self._carrier = self._carrier, None
        if carrier is not None:
            self.lm._give_carrier(carrier)

    def __enter__(self) -> "BatchSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the session is closed: its cache went back to the engine")

    def _spec_margin_ok(self) -> bool:
        """A spec round may run only while its worst case (one token for
        spec_k + 1 slots) still leaves room for every live row to finish
        its budget with plain decode: speculation may waste slots, never
        truncate a row."""
        r_max = max((r.want - len(r.tokens) for r in self.rows if r is not None), default=0)
        return self.remaining_steps() >= self.lm.spec_k + 1 + r_max - (self._pending is None)

    def _cache_in(self):
        return self._build_cache() if self._paged else self._cache

    def _state(self) -> tuple:
        """The carried state the carrier's executables take."""
        return self._cache_in(), self._logits, self._pos, self._done, self._kv_valid

    def _track(self, toks, start_pos) -> None:
        """The drafter's lockstep of `toks` [bb, S] through the carrier's
        track executable. Call under the engine lock."""
        draft_params, dcfg = self.lm._draft
        self._d_cache = self._carrier.track(
            draft_params, dcfg, self._d_cache, self._state(), toks, start_pos,
            f"lm.track_chunk[P={self.P},B={self.bb},S={toks.shape[1]}]")

    def _to_plain(self) -> None:
        """spec → plain at a chunk boundary: forward `pending` into both
        caches (one slot each) and recover the carried logits, after which
        decode_chunk and merge_rows apply unchanged."""
        if self._pending is None:
            return
        lm = self.lm
        if self._paged:
            self._ensure_decode_blocks(1)
        with lm._lock:
            t0 = time.perf_counter()
            with torch.inference_mode():
                (cache, self._logits, self._pos, self._done,
                 self._kv_valid) = self._carrier.ingest(
                    lm.params, lm.model_cfg, self._state(), self._pending,
                    f"lm.ingest_pending[B={self.bb}]")
                if not self._paged:
                    self._cache = cache
                if self._d_cache is not None:
                    # the same token into the drafter's slot, so speculation
                    # can re-enter later
                    self._track(self._pending[:, None], self._pos - 1)
            dt = time.perf_counter() - t0
            self.decode_s += dt
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.ingest_pending[B={self.bb}]", dt)
        self._pending = None
        self.steps_done += 1

    def _page_fields(self) -> dict:
        pool = self.lm.pool
        if not self._paged:
            return {}
        return {"pages_free": pool.pages_free, "pages_live": pool.pages_live,
                "pages_total": pool.n_pages - 1}

    def _step_spec(self) -> list:
        """One speculative round: the drafter proposes spec_k greedy tokens,
        the target scores all k + 1 window positions in one forward, and
        each row advances by its own accepted count. Rejected draft slots
        become kv_valid holes. A pool exhausted in the spec window turns
        the session plain for good, never an error; so does an acceptance
        EMA under 0.1 after 3 rounds."""
        lm = self.lm
        S = lm.spec_k + 1
        if self._paged:
            try:
                self._ensure_decode_blocks(S)
            except PoolExhausted:
                log.warning("page alloc for a spec window failed: the session decodes plain",
                            exc_info=True)
                self._spec_on = False
                return self.step()
        draft_params, dcfg = lm._draft
        carrier, cuda = self._carrier, lm.device.type == "cuda"
        with lm._lock:
            t0 = time.perf_counter()
            host_gap_s = max(0.0, t0 - self._last_step_end)
            with torch.inference_mode():
                first = self._pending is None
                head = []
                state = self._state()
                if first:
                    # plain → spec: the first token off the carried logits
                    state, self._pending, tok0, c0 = carrier.spec_first(
                        lm.model_cfg, self._gen, state, self._temps, self._ks, self._eos,
                        f"lm.spec_first[B={self.bb}]")
                    head = [tok0[:, None], c0.long()[:, None]]
                # the draft/verify split of the round: CUDA events around
                # the two replays on the card, read after the round's fetch
                events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else ()
                if cuda:
                    events[0].record()
                t_d = time.perf_counter()
                self._d_cache, drafts = carrier.draft(
                    draft_params, dcfg, self._d_cache, state, self._pending, lm.spec_k,
                    f"lm.draft_chunk[P={self.P},B={self.bb},k={lm.spec_k}]")
                if cuda:
                    events[1].record()
                t_v = time.perf_counter()
                state, self._pending, out, counted, emitted = carrier.verify(
                    lm.params, lm.model_cfg, self._gen, state, self._pending, drafts,
                    self._temps, self._ks, self._eos,
                    f"lm.verify_chunk[P={self.P},B={self.bb},k={lm.spec_k}]")
                if cuda:
                    events[2].record()
                cache, self._logits, self._pos, self._done, self._kv_valid = state
                if not self._paged:
                    self._cache = cache
                # the round's one device -> host fetch
                host = torch.cat(head + [out, counted.long(), emitted[:, None]],
                                 dim=1).cpu().numpy()
            t_end = time.perf_counter()
            step_s = t_end - t0
            if cuda:  # the fetch waited for the verify: both events are done
                draft_s = events[0].elapsed_time(events[1]) / 1000.0
                verify_s = events[1].elapsed_time(events[2]) / 1000.0
            else:
                draft_s, verify_s = t_v - t_d, t_end - t_v
            self.decode_s += step_s
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.draft_chunk[P={self.P},B={self.bb},k={lm.spec_k}]",
                                      draft_s)
        dispatch_ledger.note_dispatch(f"lm.verify_chunk[P={self.P},B={self.bb},k={lm.spec_k}]",
                                      verify_s)
        dispatch_ledger.note_host_sync("BatchSession._step_spec")
        if first:
            dispatch_ledger.note_dispatch(f"lm.spec_first[B={self.bb}]", t_d - t0)
        self.steps_done += S
        h = 2 if first else 0
        out, counted, em = host[:, h:h + S], host[:, h + S:h + 2 * S], host[:, -1]
        live_idx = [i for i, r in enumerate(self.rows) if r is not None]
        proposed = lm.spec_k * len(live_idx)
        accepted = sum(max(0, int(em[i]) - 1) for i in live_idx)
        emitted_total = sum(int(em[i]) for i in live_idx) + (len(live_idx) if first else 0)
        lm._spec_proposed += proposed
        lm._spec_accepted += accepted
        kv_live, kv_alloc = lm.kv_row_counts()
        mean_emitted = emitted_total / max(1, len(live_idx))
        engine_timeline.note_decode_step(
            wall_ms=step_s * 1000.0, rows_live=len(live_idx), rows_capacity=self.bb,
            kv_rows_live=kv_live, kv_rows_allocated=kv_alloc, steps=mean_emitted,
            dispatches=2 + first, host_gap_ms=host_gap_s * 1000.0,
            spec_draft_ms=draft_s * 1000.0, spec_verify_ms=verify_s * 1000.0,
            spec_proposed=proposed, spec_accepted=accepted, **self._page_fields())
        if mean_emitted > 0:
            metrics.observe("lm.tpot_ms", step_s * 1000.0 / mean_emitted,
                            labels={"service": "lm"})
        self._note_row_seconds(step_s)
        # drafter divergence: rounds that burn S slots for ~1 token are
        # worse than plain decode; off for good, this session
        rate = accepted / proposed if proposed else 0.0
        self._spec_rounds += 1
        self._spec_ema = rate if self._spec_ema is None else 0.5 * self._spec_ema + 0.5 * rate
        if self._spec_rounds >= 3 and self._spec_ema < 0.1:
            log.info("spec accept EMA %.2f after %d rounds: the session decodes plain",
                     self._spec_ema, self._spec_rounds)
            self._spec_on = False

        def pairs(i):
            if first:
                yield host[i, 0], host[i, 1]
            yield from zip(out[i, :int(em[i])], counted[i, :int(em[i])])

        return self._emit_and_finish(pairs)

    def _note_row_seconds(self, step_s: float) -> None:
        by_tenant: dict = {}
        for row in self.rows:
            if row is not None:
                by_tenant[row.tenant] = by_tenant.get(row.tenant, 0) + 1
        for tenant, n_rows in by_tenant.items():
            usage.note(tenant, kv_row_seconds=step_s * n_rows)

    def _step_plain(self) -> list:
        """One plain chunk; with a live drafter its tokens are also
        teacher-forced into the drafter's cache (one more small forward),
        so speculation can re-enter at a later boundary."""
        lm = self.lm
        chunk = min(self.chunk, self.remaining_steps())
        if self._paged:
            self._ensure_decode_blocks(chunk)  # host free-list work, off the lock
        with lm._lock:
            t0 = time.perf_counter()
            # host time since the previous chunk's device work: splices,
            # bookkeeping and the batcher's scheduling
            host_gap_s = max(0.0, t0 - self._last_step_end)
            with torch.inference_mode():
                if chunk == self.chunk:
                    # a full chunk replays the session's decode graph
                    (cache, self._logits, self._pos, self._done, self._kv_valid, toks,
                     counted) = self._carrier.chunk(
                        lm.params, lm.model_cfg, self._gen, self._cache_in(), self._logits,
                        self._pos, self._done, self._kv_valid, chunk, self._temps, self._ks,
                        self._eos, f"lm.decode_chunk[P={self.P},B={self.bb},chunk={chunk}]")
                    if not self._paged:
                        self._cache = cache
                else:  # a shorter last chunk: eagerly
                    (cache, self._logits, self._pos, self._done, toks,
                     counted) = gpt_mod.decode_chunk(
                        lm.params, self._cache_in(), self._logits, self._pos, self._done,
                        self._kv_valid, self._gen, chunk, lm.model_cfg,
                        temperature=self._temps, top_k=self._ks, eos_id=self._eos)
                    if not self._paged:
                        self._cache = cache
                if self._spec_on and self._d_cache is not None:
                    self._track(toks, self._pos - chunk)
                host = torch.stack((toks, counted.to(toks.dtype))).cpu().numpy()
            step_s = time.perf_counter() - t0
            self.decode_s += step_s
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.decode_chunk[P={self.P},B={self.bb},chunk={chunk}]",
                                      step_s)
        dispatch_ledger.note_host_sync("BatchSession._step_plain")
        self.steps_done += chunk
        # occupancy and row-seconds over the rows live DURING the chunk
        kv_live, kv_alloc = lm.kv_row_counts()
        engine_timeline.note_decode_step(
            wall_ms=step_s * 1000.0, rows_live=self.bb - self.capacity(), rows_capacity=self.bb,
            kv_rows_live=kv_live, kv_rows_allocated=kv_alloc, steps=chunk, dispatches=1,
            host_gap_ms=host_gap_s * 1000.0, **self._page_fields())
        if chunk:
            metrics.observe("lm.tpot_ms", step_s * 1000.0 / chunk, labels={"service": "lm"})
        self._note_row_seconds(step_s)
        toks, counted = host[0], host[1]
        return self._emit_and_finish(lambda i: zip(toks[i], counted[i]))

    def _emit_and_finish(self, pairs) -> list:
        """Chunk-boundary bookkeeping of each live row over host values in
        hand (`pairs(i)` iterates row i's (token, counted) run; after a spec
        round rows have runs of their own lengths): tokens, journal
        snapshots, TTFT, finishes."""
        now = time.perf_counter()
        finished = []
        jr = self.lm.journal
        journaling = jr is not None and jr.enabled
        for i, row in enumerate(self.rows):
            if row is None:
                continue
            hit_eos = False
            had_tokens = bool(row.tokens)
            for t, c in pairs(i):
                if not c:  # EOS (or a slot after it)
                    hit_eos = True
                    break
                row.tokens.append(int(t))
                if len(row.tokens) >= row.want:
                    break
            if journaling and row.task_id and row.prompt_ids is not None:
                # the row's resume snapshot, from the host values above. A
                # row carries no stream seq and no generator state: the
                # session's draws are shared by its rows, so a greedy row
                # resumes token for token and a sampled one on fresh draws
                jr.append({"task_id": row.task_id, "tenant": row.tenant, "stream": False,
                           "prompt_ids": row.prompt_ids, "max_new": int(row.want),
                           "temperature": self._temps[i], "top_k": self._ks[i],
                           "tokens": list(row.tokens), "chunk_start": len(row.tokens),
                           "text": "", "seq": 0, "key": None, "key_splits": 0,
                           # tokens[-1] is the pending token, not in the cache
                           "spec": self._pending is not None})
            if not had_tokens and row.tokens and row.first_tok is None:
                # engine-side TTFT: the row's prefill started → its first
                # token on the host
                row.first_tok = now
                metrics.observe("lm.ttft_ms", (now - row.created) * 1000.0,
                                labels={"service": "lm"})
            if hit_eos or len(row.tokens) >= row.want:
                finished.append(self._finish(i))
        if self.remaining_steps() <= 0:
            finished += self._drain_all()
        return finished

    def _finish(self, i: int):
        row = self.rows[i]
        self.rows[i] = None
        self._release_row_pages(i)
        usage.note(row.tenant, tokens_out=len(row.tokens))
        engine_timeline.note_finish(
            tokens=len(row.tokens),
            ttft_ms=(row.first_tok - row.created) * 1000.0 if row.first_tok is not None else None,
            radix_hit=row.radix_hit if self._paged else None)
        with self.lm._lock:
            self.lm.stats["generate_calls"] += 1
            self.lm.stats["tokens_generated"] += len(row.tokens)
            self.lm.stats["decode_s"] += self.decode_s
            self.decode_s = 0.0
        return (row.tag, self.lm.tokenizer.decode(row.tokens))

    def _drain_all(self) -> list:
        return [self._finish(i) for i, r in enumerate(self.rows) if r is not None]
