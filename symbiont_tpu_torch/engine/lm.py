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

Observability, as the JAX engine records it: `lm.param_bytes{dtype}`, the
`lm.params` and `lm.kv_cache` claims in the device-memory ledger, the
session KV gauges (`lm.kv_rows_active`, `lm.kv_rows_allocated`,
`lm.kv_stranded_rows`, `lm.kv_cache_bytes`, `lm.kv_rows_per_gib`),
`lm.decode_tok_per_s`, `lm.hbm_headroom_bytes`, the `lm.ttft_ms` and
`lm.tpot_ms` histograms, the engine timeline's decode events, per-tenant
usage, dispatch-ledger rows per prefill, chunk and splice, and
`maybe_profile("engine.generate")` around each batch.

Not ported yet: the paged KV layout (ROADMAP A12), speculative decoding
(A13), tensor-parallel decode over a mesh (A15), and the generation
journal with `generate_stream(resume=...)` (A8). The settings that would
switch those on raise `ValueError` naming their item; none is ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.models import gpt as gpt_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import torch_dtype
from symbiont_tpu_torch.models.convert import load_gpt_model
from symbiont_tpu_torch.models.gpt import GPTConfig
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


def _refuse_unported(cfg: LmConfig, mesh, draft_params, draft_model_cfg) -> None:
    """The settings of the JAX engine whose parts are not ported raise
    here, naming their ROADMAP item, instead of being ignored."""
    if cfg.kv_layout == "paged":
        raise ValueError("kv_layout='paged' is not ported (ROADMAP A12: paged KV)")
    if cfg.spec_draft_model or draft_params is not None or draft_model_cfg is not None:
        raise ValueError("speculative decoding (spec_draft_model, draft params) is not "
                         "ported (ROADMAP A13)")
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
        _refuse_unported(cfg, mesh, draft_params, draft_model_cfg)
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
        self._register_gauges()

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
        def kv_stranded(lm):
            # rows held in dense max-length slabs but not live: batch-bucket
            # padding and finished or cancelled rows (what paging reclaims)
            live, alloc = lm.kv_row_counts()
            return alloc - live

        def kv_bytes(lm):
            return sum(gpt_mod.cache_bytes(s._cache) for s in lm._live_sessions())

        def kv_rows_per_gib(lm):
            sessions = lm._live_sessions()
            total = sum(gpt_mod.cache_bytes(s._cache) for s in sessions)
            rows = sum(s.bb for s in sessions)
            return round(rows * (1 << 30) / total, 1) if total else 0.0

        def tok_per_s(lm):
            toks, secs = lm.stats["tokens_generated"], lm.stats["decode_s"]
            return toks / secs if secs > 0 else 0.0

        labels = {"service": "lm",
                  "kv_dtype": "int8" if self.model_cfg.kv_quant == "int8"
                  else self.model_cfg.dtype}
        for name, reader in (("lm.kv_stranded_rows", kv_stranded),
                             ("lm.kv_rows_active", lambda lm: lm.kv_row_counts()[0]),
                             ("lm.kv_rows_allocated", lambda lm: lm.kv_rows_allocated()),
                             ("lm.kv_cache_bytes", kv_bytes),
                             ("lm.kv_rows_per_gib", kv_rows_per_gib),
                             ("lm.decode_tok_per_s", tok_per_s),
                             # None retires the gauge: right on the CPU,
                             # which keeps no memory statistics
                             ("lm.hbm_headroom_bytes", lambda lm: lm.hbm_headroom_bytes())):
            metrics.register_weakref_gauge(name, self, reader, labels=labels)
        hbm_ledger.claim("lm.params", self, lambda lm: quant.param_bytes(lm.params))
        hbm_ledger.claim("lm.kv_cache", self, kv_bytes)

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

        The engine lock is held around the prefill and each chunk, never
        across a yield, so a consumer that stops reading starves no other
        caller; the stream's cache belongs to this generator frame, so
        nothing that runs between its chunks can touch it. `stats` and the
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
        prompt_ids, prompt_mask, new_bucket = self._prepare_prompts([prompt], max_new_tokens)
        # the cache has new_bucket decode slots: the largest bucket caps
        max_new_tokens = min(max_new_tokens, new_bucket)
        usage.note(tenant, tokens_in=int(prompt_mask[0].sum()))
        chunk = min(cfg.stream_chunk, new_bucket)
        bb, P = prompt_ids.shape
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
            decode_s += dt
        dispatch_ledger.note_dispatch(f"lm.prefill[P={P},B={bb},new={new_bucket}]", dt)
        slots_used = 0
        stop = False
        try:
            while len(all_tokens) < max_new_tokens and not stop:
                c_n = min(chunk, new_bucket - slots_used)
                if c_n <= 0:
                    break
                with self._lock:
                    t1 = time.perf_counter()
                    with torch.inference_mode():
                        cache, logits, pos, done, toks, counted = gpt_mod.decode_chunk(
                            self.params, cache, logits, pos, done, kv_valid, gen, c_n,
                            self.model_cfg, temperature=temperature, top_k=top_k,
                            eos_id=eos_id)
                        host = torch.stack((toks[0], counted[0].to(toks.dtype))).cpu().numpy()
                    dt1 = time.perf_counter() - t1
                    decode_s += dt1
                dispatch_ledger.note_dispatch(f"lm.decode_chunk[P={P},B=1,chunk={c_n}]", dt1)
                # the chunk-boundary fetch above: the stream's one device -> host sync
                dispatch_ledger.note_host_sync("LmEngine._generate_stream_impl")
                slots_used += c_n
                for t, c in zip(host[0], host[1]):
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
        """(live, allocated) decode rows across live sessions, in one pass."""
        sessions = self._live_sessions()
        live = sum(sum(1 for r in s.rows if r is not None) for s in sessions)
        return live, sum(s.bb for s in sessions)

    def pages_reserved(self) -> int:
        """Pages live sessions may still claim: 0 on the dense layout, the
        only one ported (the paged pool is ROADMAP A12)."""
        return 0

    def can_admit(self, n_rows: int = 1, max_kv_rows: int = 0) -> bool:
        """May `n_rows` more decode rows start? On a card, the fresh device
        bytes they may need (`_admit_bytes_forecast`) must fit its free
        bytes, else `lm.admit_hbm_rejects` counts one refusal; on the CPU,
        which keeps no memory statistics, that forecast is skipped. Then
        the allocated rows must stay within `max_kv_rows` (<= 0: no cap).
        The paged layout's page quote waits for ROADMAP A12."""
        headroom = self.hbm_headroom_bytes()
        if headroom is not None:
            if self._admit_bytes_forecast(max(1, int(n_rows))) > headroom:
                metrics.inc("lm.admit_hbm_rejects")
                return False
        if max_kv_rows <= 0:
            return True
        return self.kv_rows_allocated() + max(1, int(n_rows)) <= max_kv_rows

    def _admit_bytes_forecast(self, n_rows: int) -> int:
        """Fresh device bytes `n_rows` admissions may need: each row's dense
        cache at the largest usable (prompt, new) bucket pair (the int8
        cache's scale planes included), plus the most bytes one lm.*
        prefill under the lock has needed so far (`_prefill`; 0 before the
        first, and on the CPU)."""
        cfg, mc = self.config, self.model_cfg
        new_b = max(cfg.new_token_buckets)
        cap = mc.max_position_embeddings - new_b
        usable = [b for b in cfg.prompt_buckets if b <= cap]
        T = (usable[-1] if usable else max(cap, 1)) + new_b
        slots = mc.num_layers * T * mc.kv_heads
        if mc.kv_quant == "int8":
            per_row = 2 * slots * (mc.head_dim + 4)  # int8 codes, float32 scales
        else:
            per_row = 2 * slots * mc.head_dim * torch_dtype(mc.dtype).itemsize
        return per_row * n_rows + self._prefill_peak_growth

    def update_params(self, params) -> None:
        """Swap in new parameters (an online fine-tune's sync), placed as
        at load; serialised with decodes on the engine lock. A running
        stream or session takes them at its next chunk; its cache from the
        old parameters stays valid context."""
        with self._lock:
            self.params = self._place_params(params)

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


class _SessionRow:
    """One request in a session: its tag, budget, tokens so far, the
    tenant it bills, when its prefill started (`created`: a spliced row's
    TTFT counts its own prefill and wait) and when its first token reached
    the host."""

    __slots__ = ("tag", "want", "tokens", "tenant", "created", "first_tok")

    def __init__(self, tag: int, want: int, tenant: str = DEFAULT_TENANT,
                 created: Optional[float] = None):
        self.tag = tag
        self.want = want
        self.tokens: list = []
        self.tenant = tenant
        self.created = time.perf_counter() if created is None else created
        self.first_tok: Optional[float] = None


class BatchSession:
    """A running chunked batch decode that requests can join at chunk
    boundaries (continuous batching).

    The session decodes in `stream_chunk`-step chunks and, between chunks,
    splices newly prefilled rows into free rows (the power-of-two batch
    bucket's padding rows, or rows whose request finished) through
    `gpt.merge_rows`: an admitted request's output is exactly its
    standalone decode's (gap slots masked, logical positions carried on).

    Threads: device work runs under the engine lock and inside
    `torch.inference_mode()` (thread-local, so entered by each method);
    `prepare_admit` prefills without the lock, on whatever thread calls
    it, while `step()` decodes on another. On a card the prepared state
    carries a CUDA event recorded after its prefill on the preparing
    thread's stream; `splice` makes its own stream wait on it and marks the
    prepared tensors as used there before the rows are copied. The rest of
    the host bookkeeping has one caller at a time (GenBatcher calls
    `splice`/`step`/`cancel_tag` in turn).
    """

    def __init__(self, lm: LmEngine, prompts: Sequence[str], max_new_tokens: Sequence[int],
                 temperature=None, top_k=None, tenants=None, task_ids=None):
        cfg = lm.config
        self.lm = lm
        n = len(prompts)
        if n != len(max_new_tokens):
            raise ValueError("prompts and max_new_tokens length mismatch")
        prompt_ids, prompt_mask, self.new_bucket = lm._prepare_prompts(
            prompts, max(max_new_tokens), min_rows=cfg.session_min_rows)
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
        # host-side probes on values in hand: prefix overlap with recent
        # prompts, and each tenant's exact prompt tokens
        share = engine_timeline.prompt_prefix_share(_real_token_rows(prompt_ids, prompt_mask, n))
        for i in range(n):
            usage.note(row_tenants[i], tokens_in=int(prompt_mask[i].sum()))
        with lm._lock:
            t0 = time.perf_counter()
            self._gen = lm._child_generator()
            with torch.inference_mode():
                self._cache, self._logits, self._kv_valid, self._pos = lm._prefill(
                    lm.params, prompt_ids, prompt_mask, self.new_bucket)
                self._done = torch.zeros((self.bb,), dtype=torch.bool, device=lm.device)
            lm._prefill_shapes.add((self.bb, self.P, self.new_bucket))
            prefill_s = time.perf_counter() - t0
            self.decode_s += prefill_s
            lm.stats["sessions"] = lm.stats.get("sessions", 0) + 1
        dispatch_ledger.note_dispatch(f"lm.prefill[P={self.P},B={self.bb},new={self.new_bucket}]",
                                      prefill_s)
        engine_timeline.note_admit(rows=n, prefill_ms=prefill_s * 1000.0, prefix_share=share,
                                   kind="start")
        with lm._sessions_lock:  # the KV gauges see live sessions
            lm._sessions.add(self)
        # end of the last device work: step() splits chunk-to-chunk wall
        # into device work and host time from it
        self._last_step_end = time.perf_counter()

    # ------------------------------------------------------------ admission

    def capacity(self) -> int:
        return sum(1 for r in self.rows if r is None)

    def remaining_steps(self) -> int:
        return self.new_bucket - self.steps_done

    def round_slots(self) -> int:
        """Decode slots the next step() may use: one chunk."""
        return self.chunk

    def done(self) -> bool:
        return all(r is None for r in self.rows) or self.remaining_steps() <= 0

    def can_admit(self, prompt: str, max_new: int, lookahead_chunks: int = 0) -> bool:
        """A newcomer may join if a row is free, its budget fits the steps
        the session has left after `lookahead_chunks` more chunks (those
        that decode while its prefill runs), and its prompt fits the
        session's prompt bucket untrimmed."""
        if (self.capacity() == 0
                or int(max_new) > self.remaining_steps() - lookahead_chunks * self.round_slots()):
            return False
        return len(self.lm.tokenizer.encode(prompt or "", self.P + 1)) <= self.P

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
        not stall the running chunk. The parameters are read once; a
        concurrent `update_params` leaves this prefill on the old ones, as
        it leaves a running stream. Returns the prepared state for
        `splice`; the session is not touched."""
        cfg = self.lm.config
        t_enter = time.perf_counter()  # the spliced rows' TTFT origin
        k = len(prompts)
        bb2 = self._admission_rows(k)
        tok = self.lm.tokenizer
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
        params = self.lm.params
        t0 = time.perf_counter()
        with torch.inference_mode():
            cache_b, logits_b, kv_valid_b, pos_b = self.lm._prefill(
                params, ids, mask, self.new_bucket, note_peak=False)
            event = None
            if self.lm.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.lm.device))
        self.lm._prefill_shapes.add((bb2, self.P, self.new_bucket))
        prefill_s = time.perf_counter() - t0
        dispatch_ledger.note_dispatch(f"lm.prefill[P={self.P},B={bb2},new={self.new_bucket}]",
                                      prefill_s)
        return {"k": k, "bb2": bb2, "cache": cache_b, "logits": logits_b,
                "kv_valid": kv_valid_b, "pos": pos_b, "event": event,
                "max_new": [int(w) for w in max_new_tokens],
                "temps": self.lm._norm_sampling_rows(temperature, cfg.temperature, bb2, k, float),
                "ks": self.lm._norm_sampling_rows(top_k, cfg.top_k, bb2, k, int),
                "tenants": _norm_tenants(tenants, k), "n_tokens": n_tokens, "prefix_share": share, "t_enter": t_enter,
                "prefill_s": prefill_s}

    def splice(self, prep: dict) -> list:
        """Admission, phase 2: merge prepared rows into free rows at this
        chunk boundary, under the lock (one row copy, no prefill). Returns
        a tag per newcomer, or None where it no longer fits: chunks decoded
        since `prepare_admit` shrank the budget, and truncating would break
        standalone equivalence, so the caller queues it again."""
        free = [i for i, r in enumerate(self.rows) if r is None]
        row_map = np.full((self.bb,), -1, np.int64)
        tags: list = []
        taken = 0
        for j in range(prep["k"]):
            if taken >= len(free) or prep["max_new"][j] > self.remaining_steps():
                tags.append(None)
                continue
            i = free[taken]
            taken += 1
            row_map[i] = j
            self.rows[i] = _SessionRow(self._next_tag, prep["max_new"][j],
                                       tenant=prep["tenants"][j], created=prep["t_enter"])
            usage.note(self.rows[i].tenant, tokens_in=prep["n_tokens"][j])
            tags.append(self._next_tag)
            self._next_tag += 1
            self._temps[i] = prep["temps"][j]
            self._ks[i] = prep["ks"][j]
        if taken == 0:
            # a refused admission still paid its prefill: keep it in the time
            with self.lm._lock:
                self.decode_s += prep["prefill_s"]
            return tags
        with self.lm._lock:
            t0 = time.perf_counter()
            with torch.inference_mode():
                if prep["event"] is not None:
                    stream = torch.cuda.current_stream(self.lm.device)
                    stream.wait_event(prep["event"])
                    for t in (*prep["cache"][:-1], prep["logits"], prep["pos"],
                              prep["kv_valid"]):
                        t.record_stream(stream)
                done_b = torch.zeros((prep["bb2"],), dtype=torch.bool, device=self.lm.device)
                (self._cache, self._logits, self._pos, self._done,
                 self._kv_valid) = gpt_mod.merge_rows(
                    self._cache, self._logits, self._pos, self._done, self._kv_valid,
                    prep["cache"], prep["logits"], prep["pos"], done_b, prep["kv_valid"],
                    row_map, prompt_width=self.P)
            merge_s = time.perf_counter() - t0
            self.decode_s += merge_s + prep["prefill_s"]
            self.lm.stats["admitted"] = self.lm.stats.get("admitted", 0) + taken
        dispatch_ledger.note_dispatch(f"lm.merge_rows[P={self.P},B={self.bb}]", merge_s)
        engine_timeline.note_admit(rows=taken, prefill_ms=prep["prefill_s"] * 1000.0,
                                   prefix_share=prep["prefix_share"], kind="splice")
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
        """Abort one running request (its client went away): its row frees
        now, admissible at the next chunk boundary, `lm.kv_rows_active`
        stops counting it, and a session whose rows are all cancelled reads
        done(). Its tokens are dropped, not published. False when the tag
        is not live (it finished first)."""
        for i, row in enumerate(self.rows):
            if row is not None and row.tag == tag:
                self.rows[i] = None
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
        """Decode one chunk → [(tag, text), ...] for every request that
        finished in it (eos, its own budget or the session's). Under
        `guard_oom("lm.batch_step")`: a device OOM leaves its postmortem
        and is raised to the caller, which fails the affected requests."""
        with guard_oom("lm.batch_step"):
            if self.done():
                return self._drain_all()
            return self._step_plain()

    def _step_plain(self) -> list:
        lm = self.lm
        chunk = min(self.chunk, self.remaining_steps())
        with lm._lock:
            t0 = time.perf_counter()
            # host time since the previous chunk's device work: splices,
            # bookkeeping and the batcher's scheduling
            host_gap_s = max(0.0, t0 - self._last_step_end)
            with torch.inference_mode():
                (self._cache, self._logits, self._pos, self._done, toks,
                 counted) = gpt_mod.decode_chunk(
                    lm.params, self._cache, self._logits, self._pos, self._done,
                    self._kv_valid, self._gen, chunk, lm.model_cfg, temperature=self._temps,
                    top_k=self._ks, eos_id=self._eos)
                host = torch.stack((toks, counted.to(toks.dtype))).cpu().numpy()
            step_s = time.perf_counter() - t0
            self.decode_s += step_s
            self._last_step_end = time.perf_counter()
        dispatch_ledger.note_dispatch(f"lm.decode_chunk[P={self.P},B={self.bb},chunk={chunk}]",
                                      step_s)
        self.steps_done += chunk
        # occupancy and row-seconds over the rows live DURING the chunk
        live_rows = [r for r in self.rows if r is not None]
        kv_live, kv_alloc = lm.kv_row_counts()
        engine_timeline.note_decode_step(
            wall_ms=step_s * 1000.0, rows_live=len(live_rows), rows_capacity=self.bb,
            kv_rows_live=kv_live, kv_rows_allocated=kv_alloc, steps=chunk, dispatches=1,
            host_gap_ms=host_gap_s * 1000.0)
        if chunk:
            metrics.observe("lm.tpot_ms", step_s * 1000.0 / chunk, labels={"service": "lm"})
        by_tenant: dict = {}
        for row in live_rows:
            by_tenant[row.tenant] = by_tenant.get(row.tenant, 0) + 1
        for tenant, n_rows in by_tenant.items():
            usage.note(tenant, kv_row_seconds=step_s * n_rows)
        toks, counted = host[0], host[1]
        return self._emit_and_finish(lambda i: zip(toks[i], counted[i]))

    def _emit_and_finish(self, pairs) -> list:
        """Chunk-boundary bookkeeping of each live row over host values in
        hand (`pairs(i)` iterates row i's (token, counted) run): tokens,
        TTFT, finishes."""
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
        usage.note(row.tenant, tokens_out=len(row.tokens))
        engine_timeline.note_finish(
            tokens=len(row.tokens),
            ttft_ms=(row.first_tok - row.created) * 1000.0 if row.first_tok is not None else None)
        with self.lm._lock:
            self.lm.stats["generate_calls"] += 1
            self.lm.stats["tokens_generated"] += len(row.tokens)
            self.lm.stats["decode_s"] += self.decode_s
            self.decode_s = 0.0
        return (row.tag, self.lm.tokenizer.decode(row.tokens))

    def _drain_all(self) -> list:
        return [self._finish(i) for i, r in enumerate(self.rows) if r is not None]
