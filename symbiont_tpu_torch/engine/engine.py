"""TorchEngine — embed / fused query search / rerank on one CUDA device.

The port of `symbiont_tpu/engine/engine.py`'s `TpuEngine`, with its public
surface (`embed_texts`, `embed_query`, `embed_and_search`, `rerank`,
`warmup`, `model_cfg`, `tokenizer`, `stats`) and its semantics:

- `model_dir` / `cross_model_dir`: a local HF checkpoint is converted by
  `models/convert.py` (the cross-encoder with its pooler and classifier);
  the tokenizer comes from `model_dir`'s tokenizer.json when there is one,
  else the hash tokenizer at the model's vocab;
- synthetic mode (no `model_dir`): random weights at the configured width,
  with the depth the width implies (384 → 6 layers, 768 → 12, 1024 → 24),
  and a synthetic cross-encoder of the embedder's geometry when
  `rerank_enabled` without `cross_model_dir`;
- `quantize`: the float32 parameters are placed on the device, then
  quantized there (`models/quant.py`: bf16, or per-channel int8/fp8 codes)
  and the float32 copy dropped;
- the encoder's parameters are narrowed to the compute dtype once, at
  load, and never widened: with `quantize="none"` a bf16 engine holds bf16
  where the JAX engine holds float32 and casts per call (same values), and
  under float32 compute f16's bf16 matrices stay bf16, as in the JAX
  engine; `engine.param_bytes`'s `dtype` label says what is held: f32,
  bf16, int8 or fp8;
- `attn_impl` "auto" resolves to the plain torch attention ("xla"),
  "flash" runs the CUDA flash-attention kernel;
- batches are planned per length bucket, capped at the largest batch
  bucket (`_plan_cap`), and row-padded to a batch bucket (`_batch_bucket`),
  so the set of shapes the device sees stays |length| × |batch| buckets;
- token ids travel as uint16 when the vocab allows (int32 past 65,535, as
  the multilingual mpnet's 250,002), the attention mask is rebuilt on the
  device from the lengths, and bf16 engines ship bf16 results back; all of
  a call's batches come back in one `torch.cat` and one `.cpu()`;
- `embed_and_search` is one call: embed, L2-normalise, bf16 cosine against
  the device corpus and top-k (invalid rows at -inf, ties to the lower
  row, `memory.vector_store.cosine_topk`);
- rerank rebuilds the mask and token types from two `[B]` length vectors.

Observability, as the JAX engine records it (`obs/`, `utils/telemetry.py`):
`engine.param_bytes{dtype}`, the `engine.params` claim in the device-memory
ledger, the `engine.sentences_embedded` gauge, the padding series
(`engine.tokens_real`, `engine.tokens_padding`, `engine.batch_fill_ratio`,
`engine.bucket_pad_waste_ratio`, the flush timeline), one dispatch-ledger
row per `embed[L=..,B=..]` / `qsearch[...]` / `rerank[...]` signature, one
`engine.host_syncs_total{site}` per fetch, every batch under `guard_oom`,
and `maybe_profile` around embed, qsearch and rerank. `engine.compiles` and
`engine.compile_s` are not registered: the engine runs eagerly and
compiles nothing (no executable cache, CUDA graphs or `torch.compile`).

Not ported yet (ROADMAP Queue A): the mesh data-parallel split. The entry
points are safe to call from several threads: device work goes to the one
current stream in call order, and `_stats_lock` guards the counters.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
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
    padding_stats,
    plan_batches,
)
from symbiont_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from symbiont_tpu_torch.memory.vector_store import cosine_topk
from symbiont_tpu_torch.models import bert as bert_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import BertConfig
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.models.convert import load_bert_model
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.obs.hbm import guard_oom, hbm_ledger
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from symbiont_tpu_torch.utils.telemetry import maybe_profile, metrics

log = logging.getLogger(__name__)


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
                tree, model_cfg = load_bert_model(self.config.model_dir)
                params = bert_params_from_numpy(tree, self.device)
                del tree
                log.info("loaded checkpoint from %s", self.config.model_dir)
            else:
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
                tree, cross_cfg = load_bert_model(self.config.cross_model_dir,
                                                  with_pooler=True)
                cross_params = bert_params_from_numpy(tree, self.device)
                del tree
                log.info("loaded cross-encoder from %s", self.config.cross_model_dir)
            else:
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
        # rebinding drops the float32 trees as soon as each is placed
        params = self._place(params)
        cross_params = None if cross_params is None else self._place(cross_params)
        self.params, self.cross_params = params, cross_params
        self.tokenizer = tokenizer or load_tokenizer(self.config.model_dir,
                                                     self.model_cfg.vocab_size)
        # uint16 ids when the vocab fits: half the host→device bytes
        self._ids_dtype = (np.uint16 if self.model_cfg.vocab_size <= 65535
                           else np.int32)
        self._d2h_bf16 = self.config.dtype == "bfloat16"
        self._stats_lock = threading.Lock()
        self.stats = {"embed_calls": 0, "embed_batches": 0,
                      "sentences_embedded": 0, "rerank_calls": 0,
                      "rerank_batches": 0, "qsearch_calls": 0}
        metrics.register_weakref_gauge(
            "engine.sentences_embedded", self,
            lambda eng: eng._stat("sentences_embedded"), labels={"service": "engine"})
        metrics.gauge_set("engine.param_bytes", quant.param_bytes(self.params),
                          labels={"service": "engine",
                                  "dtype": quant.storage_label(self.params)})
        hbm_ledger.claim("engine.params", self, TorchEngine.param_bytes)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _place(self, params):
        """Parameters onto the device, quantized there per
        `config.quantize`; the encoder's float leaves then narrowed to the
        compute dtype once (the JAX executables cast float32-at-rest
        weights on every call — same values), never widened, so f16's bf16
        matrices stay bf16 under float32 compute as in the JAX engine
        (`bert_encode` casts per call). A cross-encoder head is not cast:
        as in the JAX package it meets the compute-dtype CLS vector in
        float32 (models/bert.py cross_encoder_score)."""
        dtype = bert_mod.torch_dtype(self.config.dtype)
        params = bert_mod.tree_map(lambda t: t.to(self.device), params)
        params = quant.quantize_params(params, self.config.quantize)
        return {key: (quant.narrow_params(sub, dtype)
                      if key in ("embeddings", "layers") else sub)
                for key, sub in params.items()}

    def param_bytes(self) -> int:
        """Device bytes of the embedder's and the cross-encoder's
        parameters (the `engine.params` claim)."""
        b = quant.param_bytes(self.params)
        if self.cross_params is not None:
            b += quant.param_bytes(self.cross_params)
        return b

    def _stat(self, key: str):
        with self._stats_lock:
            return self.stats[key]

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

    def _dispatch(self, sig: str, fn, *args):
        """One batch of signature `sig`: run under the OOM guard, and its
        host wall (the enqueue: the device runs on) into the dispatch
        ledger."""
        t0 = time.perf_counter()
        with guard_oom(f"engine.{sig}"):
            out = fn(*args)
        dispatch_ledger.note_dispatch(sig, time.perf_counter() - t0)
        return out

    def _note_padding(self, true_lengths, bucket: int, batch_rows: int,
                      n_real: int) -> None:
        """Padding-waste and fill-ratio series for one dispatched batch,
        and its event on the flush timeline."""
        real, total = padding_stats(true_lengths, bucket, batch_rows)
        engine_timeline.note_embed_flush(bucket, batch_rows, n_real,
                                         real_tokens=real, total_tokens=total)
        labels = {"service": "engine"}
        metrics.inc("engine.tokens_real", real, labels=labels)
        metrics.inc("engine.tokens_padding", total - real, labels=labels)
        metrics.gauge_set("engine.batch_fill_ratio",
                          round(n_real / batch_rows, 4) if batch_rows else 0.0,
                          labels=labels)
        metrics.gauge_set("engine.bucket_pad_waste_ratio",
                          round(1.0 - real / total, 4) if total else 0.0,
                          labels=labels)

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
        rows, results = [], []
        with maybe_profile("engine.embed"), torch.inference_mode():
            encoded = self.tokenizer.encode_batch(list(texts), max_len)
            lengths = [len(e) for e in encoded]
            for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
                ids, lens = pad_ids_rows([encoded[i] for i in indices], bucket,
                                         self.tokenizer.pad_id,
                                         dtype=self._ids_dtype)
                bb = self._batch_bucket(len(indices))
                ids, lens, n_real = pad_batch_rows_ids(ids, lens, bb)
                self._note_padding([lengths[i] for i in indices], bucket, bb, n_real)
                out = self._dispatch(f"embed[L={bucket},B={bb}]", self._embed_batch,
                                     ids, lens)
                results.append(out[:n_real])
                rows.extend(indices)
            fetched = torch.cat(results).cpu()
            dispatch_ledger.note_host_sync("TorchEngine.embed_texts")
        out = np.zeros((len(texts), H), np.float32)
        out[rows] = fetched.float().numpy()
        self._bump(embed_calls=1, embed_batches=len(results),
                   sentences_embedded=len(texts))
        return out

    def embed_query(self, text: str) -> np.ndarray:
        """Single query embedding (the tasks.embedding.for_query path)."""
        return self.embed_texts([text])[0]

    def _qsearch(self, ids: np.ndarray, mask: np.ndarray, corpus_dev: torch.Tensor,
                 n_valid: int, top_k: int):
        emb = bert_mod.embed_sentences(
            self.params, self._ids(ids), torch.from_numpy(mask).to(self.device),
            self.model_cfg, pooling=self.pooling, normalize=True)
        return cosine_topk(corpus_dev, emb[0], n_valid, top_k)

    def embed_and_search(self, text: str, corpus_dev: torch.Tensor,
                         n_valid: int, top_k: int):
        """Fused interactive query: tokenize on the host, then embed,
        normalise, score against the device corpus (rows L2-normalized,
        `[cap, D]` on this engine's device) and take the top-k in one call.
        Returns (scores[k], idx[k]) as numpy."""
        max_len, buckets = self._buckets(self.model_cfg)
        cap = corpus_dev.shape[0]
        with maybe_profile("engine.qsearch"), torch.inference_mode():
            encoded = self.tokenizer.encode(text, max_len)
            bucket = choose_bucket(len(encoded), buckets)
            ids, mask = pad_to_bucket([encoded], bucket, self.tokenizer.pad_id,
                                      dtype=self._ids_dtype)
            scores, idx = self._dispatch(f"qsearch[L={bucket},B={(cap, top_k)}]",
                                         self._qsearch, ids, mask, corpus_dev,
                                         n_valid, top_k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
            dispatch_ledger.note_host_sync("TorchEngine.embed_and_search")
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
        """Cross-encoder scores for (query, passage) pairs. The pairs are
        tokenized with the embedder's tokenizer, as in the JAX engine."""
        if self.cross_params is None or self.cross_cfg is None:
            raise RuntimeError("no cross-encoder model loaded")
        if len(passages) == 0:
            return np.zeros((0,), np.float32)
        max_len, buckets = self._buckets(self.cross_cfg)
        rows, results = [], []
        with maybe_profile("engine.rerank"), torch.inference_mode():
            pairs = [self.tokenizer.encode_pair(query, p, max_len) for p in passages]
            lengths = [len(ids) for ids, _ in pairs]
            # segment-A width per pair (types are a 0-run then a 1-run)
            a_widths = [sum(1 for t in types if t == 0) for _, types in pairs]
            for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
                ids, lens = pad_ids_rows([pairs[i][0] for i in indices], bucket,
                                         self.tokenizer.pad_id,
                                         dtype=self._ids_dtype)
                bb = self._batch_bucket(len(indices))
                ids, lens, n_real = pad_batch_rows_ids(ids, lens, bb)
                self._note_padding([lengths[i] for i in indices], bucket, bb, n_real)
                len_a = np.zeros(bb, np.int32)
                len_a[:n_real] = [min(a_widths[i], bucket) for i in indices]
                out = self._dispatch(f"rerank[L={bucket},B={bb}]", self._rerank_batch,
                                     ids, lens, len_a)
                results.append(out[:n_real])
                rows.extend(indices)
            fetched = torch.cat(results).cpu()
            dispatch_ledger.note_host_sync("TorchEngine.rerank")
        out = np.zeros((len(passages),), np.float32)
        out[rows] = fetched.numpy()
        self._bump(rerank_calls=1, rerank_batches=len(results))
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
                    self._dispatch(f"embed[L={L},B={bb}]", self._embed_batch,
                                   ids, lens).cpu()
                    dispatch_ledger.note_host_sync("TorchEngine.warmup")
                    if self.cross_params is not None:
                        len_a = np.full((bb,), L // 2, np.int32)
                        self._dispatch(f"rerank[L={L},B={bb}]", self._rerank_batch,
                                       ids, lens, len_a).cpu()
                        dispatch_ledger.note_host_sync("TorchEngine.warmup")
