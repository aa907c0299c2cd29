"""TorchEngine — embed / fused query search / rerank on one CUDA device.

The port of `symbiont_tpu/engine/engine.py`'s `TpuEngine`, with its public
surface (`embed_texts`, `embed_query`, `embed_and_search`, `rerank`,
`warmup`, `model_cfg`, `tokenizer`, `stats`) and its semantics:

- synthetic mode (no `model_dir`): random weights at the configured width,
  with the depth the width implies (384 → 6 layers, 768 → 12, 1024 → 24),
  and a synthetic cross-encoder of the same geometry when `rerank_enabled`;
- `attn_impl` "auto" resolves to the plain torch attention ("xla"),
  "flash" runs the CUDA flash-attention kernel;
- batches are planned per length bucket, capped at the largest batch
  bucket (`_plan_cap`), and row-padded to a batch bucket (`_batch_bucket`),
  so the set of shapes the device sees stays |length| × |batch| buckets;
- token ids travel as uint16 when the vocab allows, the attention mask is
  rebuilt on the device from the lengths, and bf16 engines ship bf16
  results back; all of a call's batches come back in one `torch.cat` and
  one `.cpu()`;
- `embed_and_search` is one call: embed, L2-normalise, bf16 cosine against
  the device corpus and top-k (invalid rows at -inf, ties to the lower
  row, `memory.vector_store.cosine_topk`);
- rerank rebuilds the mask and token types from two `[B]` length vectors.

It runs eagerly: no executable cache, CUDA graphs or `torch.compile`. Not
ported yet (ROADMAP Queue A): checkpoint loading (`model_dir`), weight
quantization, the mesh data-parallel split, and the `obs` ledgers and
metrics. The entry points are safe to call from several threads: device
work goes to the one current stream in call order, and `_stats_lock`
guards the counters.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from symbiont_tpu_torch.config import EngineConfig
from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.engine.bucketing import (
    choose_bucket,
    pad_batch_rows_ids,
    pad_ids_rows,
    pad_to_bucket,
    plan_batches,
)
from symbiont_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from symbiont_tpu_torch.memory.vector_store import cosine_topk
from symbiont_tpu_torch.models import bert as bert_mod
from symbiont_tpu_torch.models.bert import BertConfig

log = logging.getLogger(__name__)

_NOT_PORTED = ("is not ported to symbiont_tpu_torch yet "
               "(ROADMAP Queue A: model_dir checkpoint loading)")


class TorchEngine:
    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        params=None,
        model_cfg: Optional[BertConfig] = None,
        tokenizer: Optional[Tokenizer] = None,
        pooling: str = "mean",
        normalize: bool = False,
        cross_params=None,
        cross_cfg: Optional[BertConfig] = None,
        device=None,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(device, self.config.force_cpu)
        self.pooling = pooling
        self.normalize = normalize

        if params is None or model_cfg is None:
            if self.config.model_dir:
                raise NotImplementedError(f"engine.model_dir {_NOT_PORTED}")
            # synthetic mode: random weights, depth from the width's
            # checkpoint (384 → MiniLM-L6, 768 → mpnet-base L12,
            # 1024 → e5-large L24), so the work is the real model's
            d = self.config.embedding_dim
            layers = {384: 6, 768: 12, 1024: 24}.get(d, 6 if d <= 512 else 12)
            model_cfg = BertConfig(
                vocab_size=30000, hidden_size=d,
                num_layers=layers, num_heads=max(1, d // 64),
                intermediate_size=4 * d, max_position_embeddings=512,
                dtype=self.config.dtype)
            params = bert_mod.init_params(self._generator(0), model_cfg)
            log.warning("engine running with RANDOM weights (no model_dir)")
        if cross_params is None and (self.config.cross_model_dir
                                     or self.config.rerank_enabled):
            if self.config.cross_model_dir:
                raise NotImplementedError(f"engine.cross_model_dir {_NOT_PORTED}")
            cross_cfg = model_cfg
            cross_params = bert_mod.init_params(self._generator(1), cross_cfg,
                                                with_pooler=True)
            log.warning("cross-encoder running with RANDOM weights "
                        "(rerank_enabled without cross_model_dir)")

        attn_impl = self.config.attn_impl
        if attn_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"attn_impl must be auto|flash|xla, got {attn_impl!r}")
        if attn_impl == "auto":
            attn_impl = "xla"
        self.model_cfg = dataclasses.replace(
            model_cfg, dtype=self.config.dtype, attn_impl=attn_impl)
        self.cross_cfg = (None if cross_cfg is None else dataclasses.replace(
            cross_cfg, dtype=self.config.dtype, attn_impl=attn_impl))
        self.params = self._place(params)
        self.cross_params = (None if cross_params is None
                             else self._place(cross_params))
        self.tokenizer = tokenizer or load_tokenizer(self.config.model_dir,
                                                     self.model_cfg.vocab_size)
        # uint16 ids when the vocab fits: half the host→device bytes
        self._ids_dtype = (np.uint16 if self.model_cfg.vocab_size <= 65535
                           else np.int32)
        self._d2h_bf16 = self.config.dtype == "bfloat16"
        self._stats_lock = threading.Lock()
        self.stats = {"embed_calls": 0, "embed_batches": 0,
                      "sentences_embedded": 0, "rerank_calls": 0,
                      "qsearch_calls": 0}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _place(self, params):
        """Parameters onto the device; the encoder's leaves in the compute
        dtype once here (the JAX executables cast float32-at-rest weights on
        every call — same values). A cross-encoder head stays as given: it
        runs in float32 (models/bert.py cross_encoder_score)."""
        dtype = bert_mod.torch_dtype(self.config.dtype)
        out = {}
        for key, sub in params.items():
            sub = bert_mod.tree_map(lambda t: t.to(self.device), sub)
            out[key] = (bert_mod.cast_params(sub, dtype)
                        if key in ("embeddings", "layers") else sub)
        return out

    def _bump(self, **counts) -> None:
        with self._stats_lock:
            for k, v in counts.items():
                self.stats[k] += v

    @property
    def _plan_cap(self) -> int:
        """Rows per planned batch: max_batch clamped to the largest batch
        bucket, so every planned batch has a batch bucket to run in."""
        return min(self.config.max_batch, self.config.batch_buckets[-1])

    def _batch_bucket(self, n: int) -> int:
        return choose_bucket(n, self.config.batch_buckets)

    def _buckets(self, cfg: BertConfig):
        max_len = min(self.config.length_buckets[-1], cfg.max_position_embeddings)
        return max_len, [b for b in self.config.length_buckets
                         if b <= cfg.max_position_embeddings]

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        # uint16 ids travel as their int16 bit pattern (torch's uint16 is a
        # partial dtype) and are widened and unmasked on the device
        if ids.dtype == np.uint16:
            t = torch.from_numpy(ids.view(np.int16)).to(self.device)
            return t.to(torch.int64) & 0xFFFF
        return torch.from_numpy(ids).to(self.device).to(torch.int64)

    def _lengths_mask(self, lengths: np.ndarray, L: int):
        lens = torch.from_numpy(lengths).to(self.device)
        pos = torch.arange(L, device=self.device)
        return lens, (pos < lens[:, None]).to(torch.int32)

    # ---------------------------------------------------------------- embed

    def _embed_batch(self, ids: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        _, mask = self._lengths_mask(lengths, ids.shape[1])
        emb = bert_mod.embed_sentences(self.params, self._ids(ids), mask,
                                       self.model_cfg, pooling=self.pooling,
                                       normalize=self.normalize)
        return emb.to(torch.bfloat16) if self._d2h_bf16 else emb

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Texts → [n, hidden] float32 embeddings."""
        H = self.model_cfg.hidden_size
        if len(texts) == 0:
            return np.zeros((0, H), np.float32)
        max_len, buckets = self._buckets(self.model_cfg)
        encoded = self.tokenizer.encode_batch(list(texts), max_len)
        lengths = [len(e) for e in encoded]
        rows, results = [], []
        with torch.inference_mode():
            for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
                ids, lens = pad_ids_rows([encoded[i] for i in indices], bucket,
                                         self.tokenizer.pad_id,
                                         dtype=self._ids_dtype)
                ids, lens, n_real = pad_batch_rows_ids(
                    ids, lens, self._batch_bucket(len(indices)))
                results.append(self._embed_batch(ids, lens)[:n_real])
                rows.extend(indices)
            fetched = torch.cat(results).cpu()
        out = np.zeros((len(texts), H), np.float32)
        out[rows] = fetched.float().numpy()
        self._bump(embed_calls=1, embed_batches=len(results),
                   sentences_embedded=len(texts))
        return out

    def embed_query(self, text: str) -> np.ndarray:
        """Single query embedding (the tasks.embedding.for_query path)."""
        return self.embed_texts([text])[0]

    def embed_and_search(self, text: str, corpus_dev: torch.Tensor,
                         n_valid: int, top_k: int):
        """Fused interactive query: tokenize on the host, then embed,
        normalise, score against the device corpus (rows L2-normalized,
        `[cap, D]` on this engine's device) and take the top-k in one call.
        Returns (scores[k], idx[k]) as numpy."""
        max_len, buckets = self._buckets(self.model_cfg)
        encoded = self.tokenizer.encode(text, max_len)
        bucket = choose_bucket(len(encoded), buckets)
        ids, mask = pad_to_bucket([encoded], bucket, self.tokenizer.pad_id,
                                  dtype=self._ids_dtype)
        with torch.inference_mode():
            emb = bert_mod.embed_sentences(
                self.params, self._ids(ids),
                torch.from_numpy(mask).to(self.device), self.model_cfg,
                pooling=self.pooling, normalize=True)
            scores, idx = cosine_topk(corpus_dev, emb[0], n_valid, top_k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        self._bump(qsearch_calls=1)
        return scores, idx

    # --------------------------------------------------------------- rerank

    def _rerank_batch(self, ids: np.ndarray, lengths: np.ndarray,
                      len_a: np.ndarray) -> torch.Tensor:
        # mask and token-type ids rebuilt on the device from two [B] vectors
        lens, mask = self._lengths_mask(lengths, ids.shape[1])
        pos = torch.arange(ids.shape[1], device=self.device)
        la = torch.from_numpy(len_a).to(self.device)
        types = ((pos >= la[:, None]) & (pos < lens[:, None])).to(torch.int64)
        return bert_mod.cross_encoder_score(self.cross_params, self._ids(ids),
                                            mask, self.cross_cfg, types)

    def rerank(self, query: str, passages: Sequence[str]) -> np.ndarray:
        """Cross-encoder scores for (query, passage) pairs."""
        if self.cross_params is None or self.cross_cfg is None:
            raise RuntimeError("no cross-encoder model loaded")
        if len(passages) == 0:
            return np.zeros((0,), np.float32)
        max_len, buckets = self._buckets(self.cross_cfg)
        pairs = [self.tokenizer.encode_pair(query, p, max_len) for p in passages]
        lengths = [len(ids) for ids, _ in pairs]
        # segment-A width per pair (types are a 0-run then a 1-run)
        a_widths = [sum(1 for t in types if t == 0) for _, types in pairs]
        rows, results = [], []
        with torch.inference_mode():
            for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
                ids, lens = pad_ids_rows([pairs[i][0] for i in indices], bucket,
                                         self.tokenizer.pad_id,
                                         dtype=self._ids_dtype)
                bb = self._batch_bucket(len(indices))
                ids, lens, n_real = pad_batch_rows_ids(ids, lens, bb)
                len_a = np.zeros(bb, np.int32)
                len_a[:n_real] = [min(a_widths[i], bucket) for i in indices]
                results.append(self._rerank_batch(ids, lens, len_a)[:n_real])
                rows.extend(indices)
            fetched = torch.cat(results).cpu()
        out = np.zeros((len(passages),), np.float32)
        out[rows] = fetched.numpy()
        self._bump(rerank_calls=1)
        return out

    # ---------------------------------------------------------------- warm

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               batches: Optional[Sequence[int]] = None) -> None:
        """Run the hot (bucket, batch) shapes once, rerank included when a
        cross-encoder is loaded, so the first request does not pay the
        kernel build, library loading and allocator growth."""
        with torch.inference_mode():
            for L in buckets or self.config.length_buckets[:2]:
                for B in batches or self.config.batch_buckets[:2]:
                    bb = self._batch_bucket(B)
                    ids = np.ones((bb, L), self._ids_dtype)
                    lens = np.full((bb,), L, np.int32)
                    self._embed_batch(ids, lens).cpu()
                    if self.cross_params is not None:
                        len_a = np.full((bb,), L // 2, np.int32)
                        self._rerank_batch(ids, lens, len_a).cpu()
