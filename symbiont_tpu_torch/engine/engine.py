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
and `maybe_profile` around embed, qsearch and rerank.

Executables, as the JAX engine's (`_get_executable`): one per `(kind, L,
B)` for `embed`, `rerank` and `qsearch` (whose `B` is `(capacity, k)` and
whose key also names the corpus buffer), least recently used first out
past `executable_cache_size`. On CUDA an executable is a CUDA graph
(`graphs.py`) captured at its first call and replayed after, B1
inside; its capture is what the JAX engine's first-call compile is:
`stats["compiles"]`, `stats["compile_s"]` (the warm-up run, the capture
and the first replay), the `engine.compiles` / `engine.compile_s` gauges,
one `note_compile` in the dispatch ledger and one `engine.compile` span on
the `engine-compiles` trace. On the CPU (asked for explicitly) the same
executables run eagerly, so the cache and its counts behave the same.
Bulk embeds run in a pipeline: a prep thread tokenizes chunk N+1 of
`host_prep_chunk` texts while chunk N dispatches, and every batch's
result is fetched in groups of `CONCAT_FETCH_MAX`, each group's
device-to-host copy (into pinned host memory on CUDA) started before any
is read.

Data parallelism, as in JAX (A15 stage 1): with a `mesh` whose 'data'
axis is > 1 (and `data_parallel`), the parameters are replicated on every
mesh entry, the batch bucket is rounded to a multiple of the axis, and a
batch is split into contiguous row shards, real rows first, each run by
its replica's executable on its own device (a CUDA graph per replica,
B1 once per layer per replica batch) and gathered onto the lead
(`_DataParallel`); `_note_padding` keeps the per-replica
`batcher.padding_waste`, `engine.dp_shard_balance` and
`engine.dp_replicas`. A corpus row-split over the 'data' axis (the
store's) is searched by the fused query as the query vector on the lead,
handed to the store's own sharded search (each shard's top-k by an
executable on its device, then the merge, `parallel/sharding.corpus_topk`).

Over a mesh that spans processes (A15 multi-host) every process builds the
engine on the same mesh and makes the same calls in the same order; the
replicas are placed on its own entries only. The fused query runs the
query's encoder forward on the process's lead entry and hands the vector
to the store's search, whose merge reaches every process (`corpus_topk`),
so each returns the same hits. DP embed and rerank raise there
(`mesh.JAX_FETCH`): their outputs are split over 'data', and the JAX
engine cannot fetch them across processes either.

Concurrency, as in JAX: the entry points are safe to call from several
threads. `_lock` guards the executable cache and the prep pool,
`_stats_lock` the counters, and `_replay_lock` one batch's replay: the copy
in, the replay and the enqueued copy out, never a whole call, so a bulk
embed does not hold an interactive rerank or fused query behind it. The
engine's graphs share one memory pool; the lock is what keeps one graph's
replay from overwriting another's outputs before they are copied out.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from symbiont_tpu_torch.config import EngineConfig
from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.engine.bucketing import (
    choose_bucket,
    pad_batch_rows_ids,
    pad_ids_rows,
    padding_stats,
    plan_batches,
)
from symbiont_tpu_torch.graphs import ExecCache, Executable, GraphPool, pool_for
from symbiont_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from symbiont_tpu_torch.memory.vector_store import cosine_topk
from symbiont_tpu_torch.models import bert as bert_mod
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bert import BertConfig
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.models.convert import load_bert_model
from symbiont_tpu_torch.obs.device import record_compile_event
from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
from symbiont_tpu_torch.obs.hbm import guard_oom, hbm_ledger
from symbiont_tpu_torch.obs.xprof import dispatch_ledger
from symbiont_tpu_torch.parallel.mesh import JAX_FETCH, axis_size, mesh_device, refuse_spanning
from symbiont_tpu_torch.parallel.sharding import (
    Sharded,
    local_tree,
    replicate,
)
from symbiont_tpu_torch.utils.telemetry import maybe_profile, metrics

log = logging.getLogger(__name__)


def _start_host_copies(results) -> tuple:
    """Start the device-to-host copy of every result before any is read:
    each CUDA tensor is copied, non-blocking, into pinned host memory, and
    one event after the last copy marks them all done. Returns the host
    tensors and the event to wait on (None on the CPU, where the results
    are host tensors already)."""
    results = list(results)
    if not results or results[0].device.type != "cuda":
        return results, None
    hosts = []
    for r in results:
        h = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
        h.copy_(r, non_blocking=True)
        hosts.append(h)
    done = torch.cuda.Event()
    done.record()
    return hosts, done


class _DataParallel:
    """One `(kind, L, B)` executable over the mesh's 'data' axis: an
    `Executable` a replica (a CUDA graph on its device), each given its
    contiguous share of the batch's rows, real rows first, the outputs
    gathered onto the lead in replica order."""

    def __init__(self, exes, lead):
        self.exes, self.lead = exes, lead

    def __call__(self, *inputs, lock: Optional[threading.Lock] = None):
        p = inputs[0].shape[0] // len(self.exes)
        outs = [exe(*(x[r * p:(r + 1) * p] for x in inputs), lock=lock)
                for r, exe in enumerate(self.exes)]
        return torch.cat([o.to(self.lead) for o in outs])


class TorchEngine:
    # most batches fused into one device-to-host fetch (a torch.cat on the
    # device, then one copy), as in the JAX engine: it bounds the transient
    # concat buffer to CONCAT_FETCH_MAX × max_batch rows
    CONCAT_FETCH_MAX = 16

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
        mesh=None,
    ):
        self.config = config or EngineConfig()
        self.mesh = mesh
        self._n_data = (axis_size(mesh, "data") if mesh is not None and self.config.data_parallel
                        else 1)
        # an engine over a real mesh answers on the mesh's lead entry
        self.device = resolve_device(
            mesh_device(mesh, device, self.config.force_cpu)
            if mesh is not None and mesh.size > 1 else device, self.config.force_cpu)
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
        # data parallelism: the trees replicated on every mesh entry (a copy
        # each), replica r reading the entry of data index r (None where
        # another process holds it); the lead's copy answers fused queries
        self._replicas = None
        if self._n_data > 1:
            placed = replicate(mesh, {"params": params, "cross": cross_params or {}})
            self._replicas = [local_tree(placed, i) if mesh.is_local(i) else None
                              for i in (mesh.flat_index(data=r) for r in range(self._n_data))]
            lead = local_tree(placed, mesh.local_entries[0])
            self.params = lead["params"]
            if cross_params is not None:
                self.cross_params = lead["cross"]
            self._placed = placed
        self.tokenizer = tokenizer or load_tokenizer(self.config.model_dir,
                                                     self.model_cfg.vocab_size)
        # uint16 ids when the vocab fits: half the host→device bytes
        self._ids_dtype = (np.uint16 if self.model_cfg.vocab_size <= 65535
                           else np.int32)
        self._d2h_bf16 = self.config.dtype == "bfloat16"
        self._lock = threading.Lock()  # guards the prep pool's creation
        self._stats_lock = threading.Lock()  # guards the counters below
        self._replay_lock = threading.Lock()  # one batch's copy in, replay, copy out
        self._exec_cache = ExecCache(self.config.executable_cache_size)
        # the engine's graphs share one memory pool a device (replays are
        # serialised)
        self._graph_pool = GraphPool() if self.device.type == "cuda" else None
        self._graph_pools = {self.device: self._graph_pool}
        self._prep_pool = None  # lazy 1-thread pool for the ingest pipeline
        # compile_s: each executable's first call, host wall (on CUDA the
        # warm-up run, the capture and the first replay)
        self.stats = {"embed_calls": 0, "embed_batches": 0,
                      "sentences_embedded": 0, "rerank_calls": 0,
                      "rerank_batches": 0, "qsearch_calls": 0, "compiles": 0,
                      "compile_s": 0.0}
        self._register_gauges()
        metrics.gauge_set("engine.param_bytes", quant.param_bytes(self.params),
                          labels={"service": "engine",
                                  "dtype": quant.storage_label(self.params)})
        hbm_ledger.claim("engine.params", self, TorchEngine.param_bytes)
        if self._graph_pool is not None:  # the graphs' outputs and held buffers
            hbm_ledger.claim("engine.graphs", self,
                             lambda e: sum(p.nbytes() for p in list(e._graph_pools.values())))

    def _register_gauges(self) -> None:
        """`engine.compiles`, `engine.compile_s` and
        `engine.sentences_embedded` under a service label, weakref-bound so
        the registry never keeps a dead engine alive."""
        labels = {"service": "engine"}
        for key in ("compiles", "compile_s", "sentences_embedded"):
            metrics.register_weakref_gauge(f"engine.{key}", self,
                                           functools.partial(TorchEngine._stat, key=key),
                                           labels=labels)

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
        parameters (the `engine.params` claim), every replica's on its
        device."""
        if self._replicas is not None:
            return quant.param_bytes(self._placed)
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
        b = choose_bucket(n, self.config.batch_buckets)
        if self._n_data > 1:
            # the batch must divide over the data axis
            b = max(b, self._n_data)
            b = ((b + self._n_data - 1) // self._n_data) * self._n_data
        return b

    def _buckets(self, cfg: BertConfig):
        max_len = min(self.config.length_buckets[-1], cfg.max_position_embeddings)
        return max_len, [b for b in self.config.length_buckets
                         if b <= cfg.max_position_embeddings]

    @staticmethod
    def _host(a: np.ndarray) -> torch.Tensor:
        """A host array as a CPU tensor for an executable's input. uint16
        ids travel as their int16 bit pattern (torch's uint16 is a partial
        dtype) and are widened and unmasked on the device."""
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)

    @staticmethod
    def _widen_ids(ids: torch.Tensor, uint16: bool) -> torch.Tensor:
        """Ids on the device as int64, uint16 bit patterns unmasked."""
        ids = ids.to(torch.int64)
        return ids & 0xFFFF if uint16 else ids

    # ---------------------------------------------------------- executables

    def _get_executable(self, kind: str, L: int, B, corpus: Optional[torch.Tensor] = None
                        ) -> Executable:
        """The executable of `(kind, L, B)`, built on a miss (JAX's
        `_get_executable`). For `qsearch`, `B` is `(capacity, k)` and the
        key also holds the corpus buffer's address: the graph reads that
        buffer, so two stores of one capacity never share one (the
        executable keeps its corpus alive while it is cached). A miss
        builds an `Executable`, which captures at its first call; of two
        threads that race one cold key, the loser drops its executable and
        takes the winner's, so a key counts one compile. Neither the
        functions nor their first-call hook hold the engine (the hook holds
        a weakref), so a dropped engine frees its graphs without a cyclic
        collection."""
        key = (kind, L, B) if corpus is None else (kind, L, B, corpus.data_ptr())
        exe = self._exec_cache.get(key)
        if exe is not None:
            return exe
        sig = f"{kind}[L={L},B={B}]"
        ref = weakref.ref(self)

        def on_first(seconds: float) -> None:
            engine = ref()
            if engine is not None:
                engine._note_compile(sig, seconds)

        if self._replicas is not None and kind in ("embed", "rerank"):
            # one executable a replica, each on its own device (each capture
            # a compile in the dispatch ledger; the key counts one)
            exe = _DataParallel(
                [Executable(self._fn(kind, L, r), dev, pool=pool_for(self._graph_pools, dev),
                            on_first=on_first, signature=sig)
                 for r, dev in enumerate(self._replica_devices())], self.device)
        else:
            exe = Executable(self._fn(kind, L, 0, B, corpus), self.device, pool=self._graph_pool,
                             on_first=on_first, signature=sig)
        exe, won = self._exec_cache.put(key, exe)
        if won:
            self._bump(compiles=1)
        return exe

    def _replica_devices(self) -> list:
        return [self.mesh.device(data=r) for r in range(self._n_data)]

    def _refuse_sharded_fetch(self, what: str) -> None:
        """`what`'s output is split over the 'data' axis: over a mesh that
        spans processes it cannot be fetched whole, in JAX either."""
        if self._replicas is not None:
            refuse_spanning(self.mesh, f"TorchEngine's data-parallel {what}", JAX_FETCH)

    def _fn(self, kind: str, L: int, replica: int = 0, B=None, corpus=None):
        """The function of a `(kind, L, B)` executable on replica
        `replica`'s parameters (the lead's for a fused query)."""
        trees = (self._replicas[replica] if self._replicas is not None
                 and kind in ("embed", "rerank")
                 else {"params": self.params, "cross": self.cross_params})
        widen = functools.partial(TorchEngine._widen_ids, uint16=self._ids_dtype == np.uint16)
        d2h_bf16 = self._d2h_bf16
        if kind == "embed":
            params, cfg = trees["params"], self.model_cfg
            pooling, normalize = self.pooling, self.normalize

            def fn(ids, lengths):
                # the mask rebuilt on the device from the lengths; bf16
                # engines ship bf16 results back (half the d2h bytes)
                mask = (torch.arange(L, device=ids.device) < lengths[:, None]).to(torch.int32)
                emb = bert_mod.embed_sentences(params, widen(ids), mask, cfg,
                                               pooling=pooling, normalize=normalize)
                return emb.to(torch.bfloat16) if d2h_bf16 else emb
        elif kind == "qsearch":
            # the fused interactive query: forward, pool, normalise, cosine
            # against the device corpus and top-k in one program
            params, cfg, pooling = trees["params"], self.model_cfg, self.pooling
            k = B[1]

            def fn(ids, lengths, n_valid):
                mask = (torch.arange(L, device=ids.device) < lengths[:, None]).to(torch.int32)
                emb = bert_mod.embed_sentences(params, widen(ids), mask, cfg,
                                               pooling=pooling, normalize=True)
                return cosine_topk(corpus, emb[0], n_valid, k)
        elif kind == "qembed":
            # the fused query's half before a sharded corpus: the normalised
            # query vector, which each shard's search then reads
            params, cfg, pooling = trees["params"], self.model_cfg, self.pooling

            def fn(ids, lengths):
                mask = (torch.arange(L, device=ids.device) < lengths[:, None]).to(torch.int32)
                return bert_mod.embed_sentences(params, widen(ids), mask, cfg,
                                                pooling=pooling, normalize=True)[0]
        elif kind == "rerank":
            params, cfg = trees["cross"], self.cross_cfg

            def fn(ids, lengths, len_a):
                # mask and token-type ids rebuilt on the device from two [B]
                # length vectors
                pos = torch.arange(L, device=ids.device)
                mask = (pos < lengths[:, None]).to(torch.int32)
                types = ((pos >= len_a[:, None]) & (pos < lengths[:, None])).to(torch.int64)
                return bert_mod.cross_encoder_score(params, widen(ids), mask, cfg, types)
        else:
            raise ValueError(kind)
        return fn

    def _note_compile(self, sig: str, seconds: float) -> None:
        """An executable's first call: its seconds into `compile_s` and a
        span on the `engine-compiles` trace, as the JAX engine's
        `_time_first_call` (the executable notes its capture, cost and
        memory in the dispatch ledger itself)."""
        self._bump(compile_s=seconds)
        record_compile_event("engine.compile", seconds, start_s=time.time() - seconds,
                             signature=sig)

    def _dispatch(self, sig: str, exe: Executable, *inputs):
        """One batch of signature `sig` through its executable, under the
        OOM guard, its host wall into the dispatch ledger."""
        t0 = time.perf_counter()
        with guard_oom(f"engine.{sig}"):
            out = exe(*inputs, lock=self._replay_lock)
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
        if self._n_data > 1 and batch_rows:
            # DP accounting: rows shard contiguously over the 'data' axis,
            # real rows first, so the trailing replicas carry the padding.
            # Per-replica padding waste names which replicas burn cycles on
            # pad rows, and the balance gauge (min real rows / max real
            # rows) reads 1.0 when every replica does equal useful work.
            per = batch_rows // self._n_data
            real_rows = [min(max(n_real - r * per, 0), per) for r in range(self._n_data)]
            for r, rr in enumerate(real_rows):
                metrics.gauge_set("batcher.padding_waste",
                                  round(1.0 - rr / per, 4) if per else 0.0,
                                  labels={"service": "engine", "replica": str(r)})
            mx = max(real_rows)
            metrics.gauge_set("engine.dp_shard_balance",
                              round(min(real_rows) / mx, 4) if mx else 0.0, labels=labels)
            metrics.gauge_set("engine.dp_replicas", self._n_data, labels=labels)

    # ---------------------------------------------------------------- embed

    def _prep_executor(self):
        """The 1-thread pool that tokenizes the next ingest chunk while the
        calling thread pads and dispatches the current one."""
        with self._lock:
            if self._prep_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._prep_pool = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="engine-prep")
        return self._prep_pool

    def _dispatch_embed(self, encoded, offset: int, buckets, pending) -> None:
        """Plan, pad and dispatch one tokenized chunk; each batch's result
        stays on the device until the fetch. `offset` maps chunk-local
        indices back to the caller's rows."""
        lengths = [len(e) for e in encoded]
        for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
            ids, lens = pad_ids_rows([encoded[i] for i in indices], bucket,
                                     self.tokenizer.pad_id, dtype=self._ids_dtype)
            bb = self._batch_bucket(len(indices))
            ids, lens, n_real = pad_batch_rows_ids(ids, lens, bb)
            self._note_padding([lengths[i] for i in indices], bucket, bb, n_real)
            exe = self._get_executable("embed", bucket, bb)
            out = self._dispatch(f"embed[L={bucket},B={bb}]", exe, self._host(ids),
                                 torch.from_numpy(lens))
            rows = [offset + i for i in indices] if offset else indices
            pending.append((rows, n_real, out))

    def _fetch(self, pending, out: np.ndarray, site: str) -> None:
        """Every pending batch's real rows into `out`: batches concatenated
        on the device in groups of CONCAT_FETCH_MAX, every group's copy to
        the host started before any is read; one host sync per group."""
        groups = [pending[i:i + self.CONCAT_FETCH_MAX]
                  for i in range(0, len(pending), self.CONCAT_FETCH_MAX)]
        hosts, done = _start_host_copies(
            grp[0][2] if len(grp) == 1 else torch.cat([b for _, _, b in grp])
            for grp in groups)
        if done is not None:
            done.synchronize()
        for grp, host in zip(groups, hosts):
            allv = host.float().numpy()
            off = 0
            for rows, n_real, res in grp:
                out[rows] = allv[off:off + n_real]
                off += res.shape[0]
        dispatch_ledger.note_host_sync(site, len(groups))

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Texts → [n, hidden] float32 embeddings.

        Pipelined as in JAX: a prep thread tokenizes chunk N+1 while this
        thread pads and dispatches chunk N (`host_prep_chunk` texts a
        chunk); every batch's result is fetched at the end."""
        self._refuse_sharded_fetch("embed")
        H = self.model_cfg.hidden_size
        if len(texts) == 0:
            return np.zeros((0, H), np.float32)
        max_len, buckets = self._buckets(self.model_cfg)
        out = np.zeros((len(texts), H), np.float32)
        chunk = self.config.host_prep_chunk
        pending = []
        with maybe_profile("engine.embed"), torch.inference_mode():
            if 0 < chunk < len(texts):
                texts = list(texts)
                pool = self._prep_executor()
                fut = pool.submit(self.tokenizer.encode_batch, texts[:chunk], max_len)
                for start in range(0, len(texts), chunk):
                    encoded = fut.result()
                    nxt = start + chunk
                    if nxt < len(texts):
                        # prefetch before dispatching this chunk: chunk N+1
                        # tokenizes while chunk N dispatches
                        fut = pool.submit(self.tokenizer.encode_batch,
                                          texts[nxt:nxt + chunk], max_len)
                    self._dispatch_embed(encoded, start, buckets, pending)
            else:
                self._dispatch_embed(self.tokenizer.encode_batch(list(texts), max_len),
                                     0, buckets, pending)
            self._fetch(pending, out, "TorchEngine.embed_texts")
        self._bump(embed_calls=1, embed_batches=len(pending),
                   sentences_embedded=len(texts))
        return out

    def embed_query(self, text: str) -> np.ndarray:
        """Single query embedding (the tasks.embedding.for_query path)."""
        return self.embed_texts([text])[0]

    def embed_and_search(self, text: str, corpus_dev: torch.Tensor,
                         n_valid: int, top_k: int, search=None):
        """Fused interactive query: tokenize on the host, then embed,
        normalise, score against the device corpus (rows L2-normalized,
        `[cap, D]` on this engine's device) and take the top-k in one
        executable; `n_valid` travels into it as a device scalar. Returns
        (scores[k], idx[k]) as numpy. A corpus row-split over a mesh's
        'data' axis comes with its store's `search` (`(query, n_valid) →
        (scores, idx)`, its per-shard executables and the merge): the
        query vector is embedded on the lead and handed to it."""
        max_len, buckets = self._buckets(self.model_cfg)
        cap = corpus_dev.shape[0]
        with maybe_profile("engine.qsearch"), torch.inference_mode():
            encoded = self.tokenizer.encode(text, max_len)
            bucket = choose_bucket(len(encoded), buckets)
            ids, lens = pad_ids_rows([encoded], bucket, self.tokenizer.pad_id,
                                     dtype=self._ids_dtype)
            n_valid_t = torch.tensor(n_valid, dtype=torch.int64)
            if isinstance(corpus_dev, Sharded):
                # a corpus row-split over the mesh's 'data' axis: the query
                # vector on the lead, then the store's sharded search
                if search is None:
                    raise ValueError("a corpus split over a mesh is searched through its "
                                     "store's search (search=)")
                exe = self._get_executable("qembed", bucket, 1)
                query = self._dispatch(f"qembed[L={bucket},B=1]", exe, self._host(ids),
                                       torch.from_numpy(lens))
                t0 = time.perf_counter()
                scores, idx = search(query, n_valid_t)
                dispatch_ledger.note_dispatch(f"qsearch.shards[N={cap},k={top_k}]",
                                              time.perf_counter() - t0)
            else:
                exe = self._get_executable("qsearch", bucket, (cap, top_k), corpus=corpus_dev)
                scores, idx = self._dispatch(f"qsearch[L={bucket},B={(cap, top_k)}]", exe,
                                             self._host(ids), torch.from_numpy(lens), n_valid_t)
            (scores, idx), done = _start_host_copies((scores, idx))
            if done is not None:
                done.synchronize()
            dispatch_ledger.note_host_sync("TorchEngine.embed_and_search")
        self._bump(qsearch_calls=1)
        return scores.numpy(), idx.numpy()

    # --------------------------------------------------------------- rerank

    def rerank(self, query: str, passages: Sequence[str]) -> np.ndarray:
        """Cross-encoder scores for (query, passage) pairs. The pairs are
        tokenized with the embedder's tokenizer, as in the JAX engine."""
        if self.cross_params is None or self.cross_cfg is None:
            raise RuntimeError("no cross-encoder model loaded")
        self._refuse_sharded_fetch("rerank")
        if len(passages) == 0:
            return np.zeros((0,), np.float32)
        max_len, buckets = self._buckets(self.cross_cfg)
        out = np.zeros((len(passages),), np.float32)
        pending = []
        with maybe_profile("engine.rerank"), torch.inference_mode():
            pairs = [self.tokenizer.encode_pair(query, p, max_len) for p in passages]
            lengths = [len(ids) for ids, _ in pairs]
            # segment-A width per pair (types are a 0-run then a 1-run)
            a_widths = [sum(1 for t in types if t == 0) for _, types in pairs]
            for bucket, indices in plan_batches(lengths, buckets, self._plan_cap):
                ids, lens = pad_ids_rows([pairs[i][0] for i in indices], bucket,
                                         self.tokenizer.pad_id, dtype=self._ids_dtype)
                bb = self._batch_bucket(len(indices))
                ids, lens, n_real = pad_batch_rows_ids(ids, lens, bb)
                self._note_padding([lengths[i] for i in indices], bucket, bb, n_real)
                len_a = np.zeros(bb, np.int32)
                len_a[:n_real] = [min(a_widths[i], bucket) for i in indices]
                exe = self._get_executable("rerank", bucket, bb)
                pending.append((indices, n_real, self._dispatch(
                    f"rerank[L={bucket},B={bb}]", exe, self._host(ids),
                    torch.from_numpy(lens), torch.from_numpy(len_a))))
            self._fetch(pending, out, "TorchEngine.rerank")
        self._bump(rerank_calls=1, rerank_batches=len(pending))
        return out

    # ---------------------------------------------------------------- warm

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               batches: Optional[Sequence[int]] = None) -> None:
        """Capture the hot (bucket, batch) executables, rerank's too when a
        cross-encoder is loaded, so the first request does not pay the
        capture, the kernel build, library loading or allocator growth."""
        self._refuse_sharded_fetch("embed")
        with torch.inference_mode():
            for L in buckets or self.config.length_buckets[:2]:
                for B in batches or self.config.batch_buckets[:2]:
                    bb = self._batch_bucket(B)
                    ids = self._host(np.ones((bb, L), self._ids_dtype))
                    lens = torch.full((bb,), L, dtype=torch.int32)
                    out = self._dispatch(f"embed[L={L},B={bb}]",
                                         self._get_executable("embed", L, bb), ids, lens)
                    out.cpu()
                    dispatch_ledger.note_host_sync("TorchEngine.warmup")
                    if self.cross_params is not None:
                        len_a = torch.full((bb,), L // 2, dtype=torch.int32)
                        self._dispatch(f"rerank[L={L},B={bb}]",
                                       self._get_executable("rerank", L, bb),
                                       ids, lens, len_a).cpu()
                        dispatch_ledger.note_host_sync("TorchEngine.warmup")
