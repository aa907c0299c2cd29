"""Online LM fine-tuning over ingested text — the "evolving organism" loop.

Copy of `symbiont_tpu/train/online.py` on the port's trainer and engine.
The reference's whole learning story is an order-1 Markov chain retrained
from one hardcoded sentence at every boot (reference:
services/text_generator_service/src/main.rs:169-174). The text generator
service trains the Markov backend on every ingested document; this module
gives the decoder-LM backend the same property: ingested text accumulates
into packed [B, S] token batches and periodically takes a few AdamW steps
(`train/trainer.lm_train_step`), after which the updated parameters are
copied into the serving `LmEngine` — so what the organism reads changes
what it says.

Design constraints, as in JAX:
- ONE static shape: every training batch is [batch_size, seq_len]; tokens
  are packed into a ring of rows (no per-text padding, one step executable:
  on CUDA one captured graph, replayed for every later step).
- The trainer's float32 masters are its own copy from construction on (the
  step updates them in place); the engine keeps its own tensors and takes
  the new values by a copy at each sync (`LmEngine.update_params`), so its
  decode and prefill graphs replay on them with no new capture.
- Crash-safe persistence via `train/checkpoint.save_train_state`
  (optional): a restarted stack resumes from the accumulated learning
  instead of reverting to the checkpoint it booted from.
- The step's metrics are detached device scalars: no autograd graph over
  the masters outlives a step, which a graph's capture would otherwise
  depend on.

A tensor-parallel engine (`lm.mesh`) trains on masters placed on its mesh
(`trainer.shard_lm_train_state`, the megatron rules the engine's params
follow): each step is the dp×tp `lm_train_step`, eager, and a sync hands
the placed tree to `update_params`, which copies it shard for shard. The
checkpoint stays the shared on-disk format (`train/checkpoint.py` gathers
a placed state to save it and places it back on load). Over a mesh that
spans processes every process makes the same passes in the same order: the
step sums across the processes (`lm_train_step`), the sync copies each process's own
shards, and a `state_path` raises (`mesh.JAX_FETCH`: such a state cannot
be saved whole, in JAX either), so the trainer runs there with
checkpoints off.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.parallel.mesh import JAX_FETCH, refuse_spanning
from symbiont_tpu_torch.parallel.sharding import gather_tree
from symbiont_tpu_torch.train import checkpoint as ckpt
from symbiont_tpu_torch.train.trainer import (
    lm_train_step,
    make_lm_train_state,
    shard_lm_train_state,
)

log = logging.getLogger(__name__)


class OnlineLmTrainer:
    """Owns a TrainState for the LmEngine's model and feeds it ingested text.

    Thread-safe: train_on_texts serializes on an internal lock (training is
    called from executor threads by the service layer)."""

    def __init__(self, lm, learning_rate: float = 1e-4, seq_len: int = 64,
                 batch_size: int = 8, state_path: Optional[str] = None):
        if state_path:
            refuse_spanning(getattr(lm, "mesh", None), "OnlineLmTrainer's checkpoints", JAX_FETCH)
        self.lm = lm
        self.cfg = lm.model_cfg
        self.seq_len = int(min(seq_len, self.cfg.max_position_embeddings))
        self.batch_size = int(batch_size)
        self.state_path = state_path
        self._lock = threading.Lock()
        # token stream carried between passes: text beyond what one pass
        # consumes is trained later, up to MAX_PENDING_BATCHES of backlog
        # (beyond that, oldest tokens drop and stats["tokens_dropped"] counts)
        self._stream: list = []
        self.stats = {"train_steps": 0, "train_docs": 0, "last_loss": None,
                      "param_syncs": 0, "batches_trained": 0,
                      "tokens_pending": 0, "tokens_dropped": 0}

        # Master weights train in float32 whatever the serving dtype. When
        # the engine booted from a checkpoint and no saved train state will
        # be restored below, widening the engine's bf16-rounded params would
        # bake a one-time precision loss into the masters: reload the
        # pre-cast checkpoint instead.
        params = None
        resuming = bool(state_path and ckpt.train_state_exists(state_path))
        model_dir = getattr(lm.config, "model_dir", None)
        if not resuming and model_dir:
            try:
                from symbiont_tpu_torch.models import convert as convert_mod
                from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy

                ck_params, _ = convert_mod.load_gpt_model(model_dir)
                params = quant.tree_map(
                    lambda t: t.float() if t.is_floating_point() else t,
                    gpt_params_from_numpy(ck_params, lm.device))
                log.info("online LM masters initialized from the pre-cast "
                         "checkpoint at %s", model_dir)
            except Exception:
                log.exception(
                    "could not reload the checkpoint at %s for f32 masters; "
                    "falling back to the engine's (bf16-rounded) params",
                    model_dir)
        if params is None:
            def widen(a):
                # a quantized engine (lm.quantize=int8/fp8) serves
                # QuantTensor leaves: masters train on their float32
                # dequantized values, not on the codes
                if quant.is_quantized(a):
                    return a.dequantize(torch.float32)
                return a.detach().float() if a.is_floating_point() else a.detach()

            params = quant.tree_map(widen, gather_tree(lm.params, lm.device))
        # make_lm_train_state clones every leaf: no master shares storage
        # with the engine's tensors
        self.state, self._tx = make_lm_train_state(params, learning_rate)
        del params
        mesh = getattr(lm, "mesh", None)
        if mesh is not None:  # the masters on the engine's TP layout
            self.state, self._tx = shard_lm_train_state(mesh, self.state, self._tx,
                                                        arch=self.cfg.arch)
        if resuming:  # one consistent answer with the masters-init decision
            try:
                self.state, meta = ckpt.load_train_state(state_path, self.state)
                self.stats["train_steps"] = int(meta.get("steps", 0))
                log.info("online LM train state restored from %s (step %s)",
                         state_path, self.stats["train_steps"])
                self._sync_engine()
            except ValueError as e:
                log.warning("online LM train state at %s does not match the "
                            "current model (%s); starting fresh", state_path, e)

    # ----------------------------------------------------------------- data

    # a single document is capped at this many tokens per encode — bounds the
    # host memory a pathological page can pin; a crawl-scale article fits
    _DOC_TOKEN_CAP = 1 << 18

    # one training pass consumes at most this many batches; the remainder of
    # the token stream carries over to the next pass (bounds pass latency so
    # one giant ingest burst can't monopolize the device)
    MAX_BATCHES_PER_PASS = 16

    # the carried stream is bounded too: when ingest sustainedly outruns
    # training throughput, tokens past this many batches' worth are dropped
    # OLDEST-first (counted in stats) — recent text wins, host memory stays
    # flat. MAX_BATCHES_PER_PASS bounds pass latency; this bounds backlog.
    MAX_PENDING_BATCHES = 64

    def _take_batches(self, texts: Sequence[str]):
        """Tokenize texts (BOS-separated) into the carried token stream,
        then drain as many full [batch_size, seq_len] batches as available
        (≤ MAX_BATCHES_PER_PASS). Leftover tokens stay in the stream for the
        NEXT pass, bounded at MAX_PENDING_BATCHES batches' worth — past that,
        oldest tokens drop (counted in stats["tokens_dropped"]). A stream too
        short for one full batch is cycled to fill it (short corpora still
        train). Batches are int64 tensors on the engine's device."""
        tok = self.lm.tokenizer
        bos = getattr(tok, "bos_id", 0)
        for t in texts:
            ids = tok.encode(t, self._DOC_TOKEN_CAP)
            if ids:
                self._stream.extend(ids if ids[0] == bos else [bos] + ids)
        need = self.batch_size * self.seq_len
        cap = need * self.MAX_PENDING_BATCHES
        if len(self._stream) > cap:
            drop = len(self._stream) - cap
            del self._stream[:drop]  # oldest first: recent context wins
            self.stats["tokens_dropped"] += drop
            log.warning("online LM backlog over %d tokens; dropped %d oldest",
                        cap, drop)
        chunks: list = []
        while len(self._stream) >= need and len(chunks) < self.MAX_BATCHES_PER_PASS:
            chunks.append(self._stream[:need])
            del self._stream[:need]
        if not chunks:
            if len(self._stream) < 2:  # nothing to learn from
                return []
            reps = -(-need // len(self._stream))
            chunks = [(self._stream * reps)[:need]]
            self._stream = []
        out = []
        for chunk in chunks:
            ids = torch.from_numpy(np.asarray(chunk, np.int64).reshape(
                self.batch_size, self.seq_len)).to(self.lm.device)
            out.append({"ids": ids, "mask": torch.ones_like(ids)})
        self.stats["tokens_pending"] = len(self._stream)
        return out

    # ---------------------------------------------------------------- train

    def train_on_texts(self, texts: Sequence[str], steps: int = 1) -> dict:
        """Run `steps` optimizer steps over each drained batch, then copy
        the updated params into the serving engine. Returns metrics
        including the last step's loss."""
        with self._lock:
            batches = self._take_batches(texts)
            if not batches:
                return {"loss": None, "steps": 0}
            loss = None
            n_steps = 0
            for batch in batches:
                for _ in range(max(1, int(steps))):
                    self.state, metrics = lm_train_step(self.state, batch,
                                                        self.cfg, self._tx)
                    loss = metrics["loss"]
                    n_steps += 1
            loss = float(loss)  # waits for the pass
            self.stats["train_steps"] += n_steps
            self.stats["train_docs"] += len(texts)
            self.stats["batches_trained"] += len(batches)
            self.stats["last_loss"] = loss
            self._sync_engine()
            if self.state_path:
                self._save()
        return {"loss": loss, "steps": n_steps, "batches": len(batches)}

    def _sync_engine(self) -> None:
        """Push the trained params to the serving engine, which copies them
        into its own tensors (`LmEngine.update_params`; shard for shard,
        placed masters of a TP engine as they are): the masters stay the
        trainer's alone."""
        self.lm.update_params(quant.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, self.state.params))
        self.stats["param_syncs"] += 1

    def _save(self) -> None:
        try:
            ckpt.save_train_state(self.state_path, self.state,
                                  meta={"steps": self.stats["train_steps"]})
        except OSError:
            log.exception("online LM train-state save failed; continuing")
