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
from the engine's under the lock, so its tokens do not depend on what other
callers interleave.

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

Not ported yet: tensor-parallel decode over a mesh (ROADMAP A15), and the
generation journal with `generate_stream(resume=...)` and the radix
`peek` it reads (A8). The settings that would switch those on raise
`ValueError` naming their item; none is ignored.
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
from symbiont_tpu_torch.kv import paged as paged_mod
from symbiont_tpu_torch.kv.pool import PagePool, PoolExhausted, kv_dtype_label
from symbiont_tpu_torch.kv.radix import RadixCache
from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.models.convert import load_gpt_model
from symbiont_tpu_torch.models.gpt import GPTConfig, PagedKVCache
from symbiont_tpu_torch.obs.device import local_device_stats
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.obs.hbm import guard_oom, hbm_ledger
from symbiont_tpu_torch.obs.usage import usage
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from symbiont_tpu_torch.resilience.admission import DEFAULT_TENANT
from symbiont_tpu_torch.utils.telemetry import maybe_profile, metrics

log = logging.getLogger(__name__)


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


def _refuse_unported(cfg: LmConfig, mesh) -> None:
    """The settings of the JAX engine whose parts are not ported raise
    here, naming their ROADMAP item, instead of being ignored."""
    if cfg.tensor_parallel == "on" or mesh is not None:
        raise ValueError("tensor-parallel decode (tensor_parallel='on', a mesh) is not "
                         "ported (ROADMAP A15: multi-device)")


class LmEngine:
    """Owns the LM's parameters on one device and decodes batches of
    prompts. Thread-safe: `_lock` serialises decodes and parameter swaps."""

    def __init__(self, config: Optional[LmConfig] = None, params=None,
                 model_cfg: Optional[GPTConfig] = None, tokenizer=None,
                 mesh=None, draft_params=None, draft_model_cfg=None, device=None):
        self.config = config or LmConfig()
        cfg = self.config
        _refuse_unported(cfg, mesh)
        self.device = resolve_device(device, cfg.force_cpu)

        if params is None or model_cfg is None:
            if cfg.model_dir:
                params, model_cfg = load_gpt_model(cfg.model_dir)
                log.info("loaded LM checkpoint from %s", cfg.model_dir)
            else:
                # synthetic mode: byte-level vocab, random weights
                model_cfg = GPTConfig(
                    vocab_size=ByteTokenizer.vocab_size, hidden_size=cfg.hidden_size,
                    num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                    intermediate_size=cfg.intermediate_size,
                    max_position_embeddings=cfg.max_positions, arch=cfg.arch,
                    dtype=cfg.dtype)
                params = gpt_mod.init_params(self._new_generator(0), model_cfg)
                log.warning("LM running with RANDOM weights (no lm model_dir)")
        attn_impl = cfg.attn_impl
        if attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attn_impl must be auto|flash|xla, got {attn_impl!r}")
        if attn_impl == "auto":
            attn_impl = "xla"
        self.model_cfg = dataclasses.replace(model_cfg, dtype=cfg.dtype, attn_impl=attn_impl,
                                             kv_quant=cfg.kv_quant)
        self.params = self._place_params(params)
        del params

        if tokenizer is None:
            tokenizer = ByteTokenizer()
            if cfg.model_dir and (Path(cfg.model_dir) / "tokenizer.json").exists():
                tokenizer = LmHFTokenizer(Path(cfg.model_dir) / "tokenizer.json")
        self.tokenizer = tokenizer
        self._generator = self._new_generator(cfg.seed)
        self._lock = threading.Lock()
        # prefill shapes (rows, prompt bucket, new bucket) already run by
        # session starts and admissions: the batcher's guess of whether an
        # admission prefill is cheap (GenBatcher._filter_candidates)
        self._prefill_shapes: set = set()
        # the most bytes one lm.* prefill taken under the lock has needed
        # above what was live at its start: the scratch term of the
        # admission bytes forecast (`_prefill`)
        self._prefill_peak_growth = 0
        self.stats = {"generate_calls": 0, "tokens_generated": 0, "decode_s": 0.0}
        # live sessions (BatchSession registers itself), weak so a finished
        # one drops out of the KV gauges; their own lock, since sessions
        # register from executor threads while scrapes iterate
        self._sessions: "weakref.WeakSet" = weakref.WeakSet()
        self._sessions_lock = threading.Lock()
        # paged KV: one engine-wide page pool and, optionally, the radix
        # prefix cache over committed prompt pages; the dense layout leaves
        # both None
        self.pool: Optional[PagePool] = None
        self.radix: Optional[RadixCache] = None
        if cfg.kv_layout == "paged":
            mc = self.model_cfg
            n_pages = cfg.kv_pool_pages or self._auto_pool_pages()
            self.pool = PagePool(mc.num_layers, n_pages, cfg.kv_page_tokens, mc.kv_heads,
                                 mc.head_dim, torch_dtype(mc.dtype),
                                 quantized=mc.kv_quant == "int8",
                                 dtype_label=kv_dtype_label(mc.dtype, mc.kv_quant),
                                 device=self.device)
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

    def _child_generator(self) -> torch.Generator:
        """A generator of its own for one stream or session, seeded by one
        draw from the engine's. The caller holds the engine lock."""
        seed = torch.randint(0, 2 ** 62, (1,), generator=self._generator, device=self.device)
        return self._new_generator(int(seed.item()))

    def _live_sessions(self) -> list:
        with self._sessions_lock:
            return [s for s in self._sessions if not s.done()]

    @property
    def journal(self):
        """The generation journal of the JAX engine: not ported (ROADMAP
        A8); only None may be set."""
        return None

    @journal.setter
    def journal(self, value) -> None:
        if value is not None:
            raise ValueError("the generation journal is not ported (ROADMAP A8: the stack)")

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
        Used by `__init__` and `update_params`."""
        mode = self.config.quantize
        dtype = torch_dtype(self.model_cfg.dtype)

        def place(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            a = quant.cast_params(a.to(self.device), dtype)
            return quant.quantize_params(a, mode)

        params = quant.tree_map(place, params)
        self._note_param_bytes(params, mode if mode != "none" else self.model_cfg.dtype)
        return params

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
                tokens, lengths = gpt_mod.generate(
                    self.params, self._device_ids(prompt_ids), self._device_ids(prompt_mask),
                    self._generator, self.model_cfg, max_new_tokens=new_bucket,
                    temperature=temps, top_k=ks, eos_id=int(eos_id))
                tokens = tokens.cpu().numpy()  # the fetch waits for the whole decode
                lengths = lengths.cpu().numpy()
            self.stats["generate_calls"] += 1
            self.stats["decode_s"] += time.perf_counter() - t0
            out = []
            for i, want in enumerate(max_new_tokens):  # drops the padding rows
                k = min(int(lengths[i]), int(want))
                self.stats["tokens_generated"] += k
                out.append(self.tokenizer.decode(tokens[i, :k]))
        return out

    def _prefill(self, params, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                 new_bucket: int, note_peak: bool = True):
        """`gpt.prefill` of host prompt arrays → (cache, logits, kv_valid,
        prompt_len) on the device. Call under `torch.inference_mode()`.

        With `note_peak`, records the call's peak bytes above what was live
        at its start (its cache included): the scratch term of
        `_admit_bytes_forecast`. The allocator keeps one peak for the whole
        process, so the reading is exact only when this call raises it;
        else the bytes it leaves allocated are the floor taken. Other
        threads' allocations in the meantime count too: the admission
        prefill, which runs beside a decoding `step()`, passes
        `note_peak=False`."""
        cuda = self.device.type == "cuda" and note_peak
        if cuda:
            live0 = torch.cuda.memory_allocated(self.device)
            peak0 = torch.cuda.max_memory_allocated(self.device)
        out = gpt_mod.prefill(params, self._device_ids(prompt_ids), self._device_ids(prompt_mask),
                              self.model_cfg, new_bucket)
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            top = peak if peak > peak0 else torch.cuda.memory_allocated(self.device)
            self._prefill_peak_growth = max(self._prefill_peak_growth, top - live0)
        return out

    def _draft_prefill(self, prompt_ids: np.ndarray, prompt_mask: np.ndarray,
                       new_bucket: int):
        """The drafter's dense cache at the target's (prompt, new) geometry,
        slot for slot the target's, so both share one kv_valid, pos and
        done. Call under `torch.inference_mode()`."""
        draft_params, dcfg = self._draft
        return gpt_mod.prefill(draft_params, self._device_ids(prompt_ids),
                               self._device_ids(prompt_mask), dcfg, new_bucket)[0]

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

        The engine lock is held around the prefill and each chunk or round,
        never across a yield, so a consumer that stops reading starves no
        other caller; the stream's caches belong to this generator frame, so
        nothing that runs between its chunks can touch them. `stats` and the
        usage ledger are charged in `finally`, also when the consumer
        closes the stream. `task_id` and `stream` are taken as the JAX
        engine takes them, and without a journal they record nothing;
        `resume=` needs the journal (ROADMAP A8) and raises."""
        if resume is not None:
            raise ValueError("generate_stream(resume=...) needs the generation journal, "
                             "which is not ported (ROADMAP A8: the stack)")
        cfg = self.config
        temperature = float(cfg.temperature if temperature is None else temperature)
        top_k = int(cfg.top_k if top_k is None else top_k)
        tenant = tenant or DEFAULT_TENANT
        eos_id = int(getattr(self.tokenizer, "eos_id", -1))
        spec_on = self._draft is not None
        prompt_ids, prompt_mask, new_bucket = self._prepare_prompts(
            [prompt], max_new_tokens + (self.spec_k if spec_on else 0))
        # the cache has new_bucket decode slots: the largest bucket caps
        max_new_tokens = min(max_new_tokens, new_bucket)
        usage.note(tenant, tokens_in=int(prompt_mask[0].sum()))
        chunk = min(cfg.stream_chunk, new_bucket)
        bb, P = prompt_ids.shape
        sampling = dict(temperature=temperature, top_k=top_k, eos_id=eos_id)
        all_tokens: list = []
        decoder = IncrementalDecoder(self.tokenizer)
        decode_s = 0.0
        with self._lock:
            t0 = time.perf_counter()  # inside the lock: this stream's own work
            gen = self._child_generator()
            with torch.inference_mode():
                cache, logits, kv_valid, pos = self._prefill(self.params, prompt_ids,
                                                             prompt_mask, new_bucket)
                done = torch.zeros((bb,), dtype=torch.bool, device=self.device)
                dt = time.perf_counter() - t0
                if spec_on:
                    d_cache = self._draft_prefill(prompt_ids, prompt_mask, new_bucket)
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
        try:
            while len(all_tokens) < max_new_tokens and not stop:
                left = max_new_tokens - len(all_tokens)
                if spec_on and new_bucket - slots_used < S + left - (pending is None):
                    # no room for a worst-case round and a plain finish: leave
                    # speculation for good (one row: the margin only shrinks)
                    if pending is not None:
                        with self._lock:
                            t1 = time.perf_counter()
                            with torch.inference_mode():
                                cache, logits, pos = gpt_mod.ingest_pending(
                                    self.params, cache, pending, pos, done, kv_valid,
                                    self.model_cfg)
                            dt1 = time.perf_counter() - t1
                            decode_s += dt1
                        dispatch_ledger.note_dispatch("lm.ingest_pending[B=1]", dt1)
                        slots_used += 1
                        pending = None
                    spec_on = False
                if spec_on:
                    draft_params, dcfg = self._draft
                    with self._lock:
                        t1 = time.perf_counter()
                        with torch.inference_mode():
                            first = pending is None
                            if first:
                                # plain → spec: the first token off the carried
                                # logits, what the next plain step would sample
                                pending, c0, done = gpt_mod.spec_first(
                                    logits, done, gen, self.model_cfg, **sampling)
                                head = [pending, c0.long()]
                            t_d = time.perf_counter()
                            d_cache, drafts = gpt_mod.draft_chunk(
                                draft_params, d_cache, pending, pos, done, kv_valid, dcfg,
                                self.spec_k)
                            t_v = time.perf_counter()
                            (cache, pending, pos, done, kv_valid, out, counted,
                             emitted) = gpt_mod.verify_chunk(
                                self.params, cache, pending, drafts, pos, done, kv_valid, gen,
                                self.model_cfg, **sampling)
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
                for t, c in pairs:
                    if not c:  # EOS (or a slot after it): the stream ends here
                        stop = True
                        break
                    all_tokens.append(int(t))
                    if len(all_tokens) >= max_new_tokens:
                        break
                delta = decoder.push(all_tokens)
                if delta:
                    yield delta
            final_delta = decoder.flush(all_tokens)
            if final_delta:
                yield final_delta
        finally:
            # on a normal end and on close (the client went away)
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
        `session.admit()` or `prepare_admit` + `splice`. `tenants` (one per
        prompt) routes the usage ledger; `task_ids` are taken as the JAX
        engine takes them and, without a journal, record nothing."""
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
        """Fresh device bytes `n_rows` admissions may need: on the dense
        layout each row's cache at the largest usable (prompt, new) bucket
        pair (the int8 cache's scale planes included; paged rows take pages
        of the resident pool, no fresh bytes), plus the most bytes one lm.*
        prefill under the lock has needed so far (`_prefill`; 0 before the
        first, and on the CPU)."""
        mc = self.model_cfg
        per_row = 0
        if self.pool is None:
            slots = mc.num_layers * self._largest_span() * mc.kv_heads
            if mc.kv_quant == "int8":
                per_row = 2 * slots * (mc.head_dim + 4)  # int8 codes, float32 scales
            else:
                per_row = 2 * slots * mc.head_dim * torch_dtype(mc.dtype).itemsize
        return per_row * n_rows + self._prefill_peak_growth

    def update_params(self, params) -> None:
        """Swap in new parameters (an online fine-tune's sync), placed as
        at load; serialised with decodes on the engine lock. A running
        stream or session takes them at its next chunk; its cache from the
        old parameters stays valid context. Committed prefix pages and
        their logits are stale under the new weights: the radix cache is
        cleared (live rows keep their own pages)."""
        with self._lock:
            self.params = self._place_params(params)
        if self.radix is not None:
            self.radix.clear()

    def warmup(self, new_bucket: Optional[int] = None) -> None:
        """Run the hot (prompt, new) shape once, so the first request does
        not pay the kernel build, library loading and allocator growth."""
        self.generate("warmup", new_bucket or self.config.new_token_buckets[0])


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
    skipped)."""

    __slots__ = ("tag", "want", "tokens", "tenant", "created", "first_tok", "radix_hit")

    def __init__(self, tag: int, want: int, tenant: str = DEFAULT_TENANT,
                 created: Optional[float] = None, radix_hit: bool = False):
        self.tag = tag
        self.want = want
        self.tokens: list = []
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
        self.rows: list = [_SessionRow(i, min(int(w), self.new_bucket), tenant=row_tenants[i])
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
            self._pt_dev = None
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
        with lm._lock:
            t0 = time.perf_counter()
            self._gen = lm._child_generator()
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
                    staging, self._logits, self._kv_valid, self._pos = lm._prefill(
                        lm.params, prompt_ids, prompt_mask, self.new_bucket)
                    lm._prefill_shapes.add((self.bb, self.P, self.new_bucket))
                    self._cache = staging
                    if self._paged:
                        # adopt the staged prefill into the pool: each real
                        # row's fresh prompt blocks only, bit for bit
                        scatter = np.zeros((self.bb, self._prompt_blocks), np.int64)
                        for i in range(n):
                            nsh = matches[i].blocks if matches[i] else 0
                            scatter[i, nsh:] = self._pt[i, nsh:self._prompt_blocks]
                        pool = lm.pool
                        paged_mod.scatter_prompt(pool.k, pool.v, pool.k_scale, pool.v_scale,
                                                 staging, torch.from_numpy(scatter).to(dev),
                                                 self.P)
                        self._cache = None
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
                        self._d_cache = lm._draft_prefill(prompt_ids, prompt_mask,
                                                          self.new_bucket)
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

    def _build_cache(self) -> PagedKVCache:
        """The paged cache view for the next device call: the pool's
        tensors, this session's device page table (rebuilt from the host
        one if it changed) and its length, P + steps_done."""
        pool = self.lm.pool
        if self._pt_dirty:
            self._pt_dev = torch.from_numpy(self._pt.copy()).to(self.lm.device)
            self._pt_dirty = False
        return PagedKVCache(pool.k, pool.v, pool.k_scale, pool.v_scale, self._pt_dev,
                            self.P + self.steps_done)

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
        """Whether admitting k newcomers prefills at a shape the engine has
        already run (its first run pays library loading and allocator
        growth)."""
        return (self._admission_rows(k), self.P, self.new_bucket) in self.lm._prefill_shapes

    def prepare_admit(self, prompts: Sequence[str], max_new_tokens: Sequence[int],
                      temperature=None, top_k=None, tenants=None, task_ids=None) -> dict:
        """Admission, phase 1: tokenize and prefill the newcomers at the
        session's prompt bucket WITHOUT the engine lock, so the prefill does
        not stall the running chunk; with a drafter, its rows too. Paged,
        a radix probe (no refcounts taken) skips the target prefill when
        every newcomer is a full hit; `splice` matches again under the pool
        lock. The parameters are read once; a concurrent `update_params`
        leaves this prefill on the old ones, as it leaves a running stream.
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
                cache_b, logits_b, kv_valid_b, pos_b = lm._prefill(
                    params, ids, mask, self.new_bucket, note_peak=False)
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
                                           radix_hit=self._paged and prep["cache"] is None)
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
                    cache_b = (prep["cache"], torch.from_numpy(scatter).to(dev), cache_a.page_table)
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

    def _spec_margin_ok(self) -> bool:
        """A spec round may run only while its worst case (one token for
        spec_k + 1 slots) still leaves room for every live row to finish
        its budget with plain decode: speculation may waste slots, never
        truncate a row."""
        r_max = max((r.want - len(r.tokens) for r in self.rows if r is not None), default=0)
        return self.remaining_steps() >= self.lm.spec_k + 1 + r_max - (self._pending is None)

    def _cache_in(self):
        return self._build_cache() if self._paged else self._cache

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
                cache, self._logits, self._pos = gpt_mod.ingest_pending(
                    lm.params, self._cache_in(), self._pending, self._pos, self._done,
                    self._kv_valid, lm.model_cfg)
                if not self._paged:
                    self._cache = cache
                if self._d_cache is not None:
                    # the same token into the drafter's slot, so speculation
                    # can re-enter later
                    draft_params, dcfg = lm._draft
                    self._d_cache = gpt_mod.track_chunk(draft_params, self._d_cache,
                                                        self._pending[:, None], self._pos - 1,
                                                        self._kv_valid, dcfg)
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
        with lm._lock:
            t0 = time.perf_counter()
            host_gap_s = max(0.0, t0 - self._last_step_end)
            with torch.inference_mode():
                first = self._pending is None
                head = []
                if first:
                    # plain → spec: the first token off the carried logits
                    self._pending, c0, self._done = gpt_mod.spec_first(
                        self._logits, self._done, self._gen, lm.model_cfg,
                        temperature=self._temps, top_k=self._ks, eos_id=self._eos)
                    head = [self._pending[:, None], c0.long()[:, None]]
                t_d = time.perf_counter()
                self._d_cache, drafts = gpt_mod.draft_chunk(
                    draft_params, self._d_cache, self._pending, self._pos, self._done,
                    self._kv_valid, dcfg, lm.spec_k)
                if drafts.is_cuda:  # the draft/verify split of the round's wall
                    torch.cuda.current_stream(drafts.device).synchronize()
                t_v = time.perf_counter()
                (cache, self._pending, self._pos, self._done, self._kv_valid, out, counted,
                 emitted) = gpt_mod.verify_chunk(
                    lm.params, self._cache_in(), self._pending, drafts, self._pos, self._done,
                    self._kv_valid, self._gen, lm.model_cfg, temperature=self._temps,
                    top_k=self._ks, eos_id=self._eos)
                if not self._paged:
                    self._cache = cache
                # the round's one device -> host fetch
                host = torch.cat(head + [out, counted.long(), emitted[:, None]],
                                 dim=1).cpu().numpy()
            t_end = time.perf_counter()
            step_s, draft_s, verify_s = t_end - t0, t_v - t_d, t_end - t_v
            self.decode_s += step_s
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.draft_chunk[P={self.P},B={self.bb},k={lm.spec_k}]",
                                      draft_s)
        dispatch_ledger.note_dispatch(f"lm.verify_chunk[P={self.P},B={self.bb},k={lm.spec_k}]",
                                      verify_s)
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
                (cache, self._logits, self._pos, self._done, toks,
                 counted) = gpt_mod.decode_chunk(
                    lm.params, self._cache_in(), self._logits, self._pos, self._done,
                    self._kv_valid, self._gen, chunk, lm.model_cfg, temperature=self._temps,
                    top_k=self._ks, eos_id=self._eos)
                if not self._paged:
                    self._cache = cache
                if self._spec_on and self._d_cache is not None:
                    draft_params, dcfg = lm._draft
                    self._d_cache = gpt_mod.track_chunk(draft_params, self._d_cache, toks,
                                                        self._pos - chunk, self._kv_valid, dcfg)
                host = torch.stack((toks, counted.to(toks.dtype))).cpu().numpy()
            step_s = time.perf_counter() - t0
            self.decode_s += step_s
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.decode_chunk[P={self.P},B={self.bb},chunk={chunk}]",
                                      step_s)
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
        round rows have runs of their own lengths): tokens, TTFT,
        finishes."""
        now = time.perf_counter()
        finished = []
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
