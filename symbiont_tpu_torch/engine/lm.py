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

Observability, as the JAX engine records it: `lm.param_bytes{dtype}`, the
`lm.params` claim in the device-memory ledger, `lm.decode_tok_per_s`, and
`maybe_profile("engine.generate")` around each batch.

Not ported yet (ROADMAP A11's rest and later items): `generate_stream`,
`BatchSession`/`GenBatcher` continuous batching with `can_admit`,
`prepare_admit` and `splice`, the session KV gauges and the decode half of
the engine timeline (A11); the paged KV layout (A12); speculative decoding
(A13); tensor-parallel decode over a mesh (A15); the generation journal
(A8). The settings that would switch those on raise `ValueError` naming
their item; none is ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
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
from symbiont_tpu_torch.obs.hbm import hbm_ledger
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
        self.stats = {"generate_calls": 0, "tokens_generated": 0, "decode_s": 0.0}
        self._register_gauges()

    def _new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

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
        def tok_per_s(lm):
            toks, secs = lm.stats["tokens_generated"], lm.stats["decode_s"]
            return toks / secs if secs > 0 else 0.0

        labels = {"service": "lm",
                  "kv_dtype": "int8" if self.model_cfg.kv_quant == "int8"
                  else self.model_cfg.dtype}
        metrics.register_weakref_gauge("lm.decode_tok_per_s", self, tok_per_s,
                                       labels=labels)
        hbm_ledger.claim("lm.params", self, lambda lm: quant.param_bytes(lm.params))

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

    def update_params(self, params) -> None:
        """Swap in new parameters (an online fine-tune's sync), placed as
        at load; serialised with decodes on the engine lock."""
        with self._lock:
            self.params = self._place_params(params)

    def warmup(self, new_bucket: Optional[int] = None) -> None:
        """Run the hot (prompt, new) shape once, so the first request does
        not pay the kernel build, library loading and allocator growth."""
        self.generate("warmup", new_bucket or self.config.new_token_buckets[0])
