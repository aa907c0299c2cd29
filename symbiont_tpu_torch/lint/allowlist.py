"""The port's central lint allowlist — every deliberate exception of the
port's tree, in one module, each with a reason.

Counterpart of the JAX package's `symbiont_tpu/lint/allowlist.py`, with the
same conventions (enforced by the engine):

- an entry suppresses findings for ONE exact site (formats below) — never
  a file, never a rule;
- a STALE entry (one whose site no longer exists) is itself an error
  (``stale-allowlist``): when the code a waiver covered goes away, the
  waiver must go with it, so this file can only shrink ratchet-style;
- adding an entry requires the reason string to say WHY the site is
  exempt, not what it is.

Every site is keyed on a ``symbiont_tpu_torch/...`` file. An entry that
mirrors a JAX entry names the port's site and keeps JAX's reason where the
reason carries over.

Entry formats per table:
- ``(repo-relative file, dotted scope)`` — scope is the indent-stack
  qualified function path (``EngineService._rerank.op``);
- subject-constant NAME (SUBJECTS_UNPRODUCED_ALLOWED);
- canonical cycle string ``"a.B.c -> d.E.f -> a.B.c"`` (LOCK_ORDER_ALLOWED).
"""

from __future__ import annotations

# ---------------------------------------------------------------- wiring
# Served-but-uncalled endpoints kept deliberately: the engine plane and the
# stores are a public RPC surface for native worker shells, external bus
# clients and load harnesses. Anything else showing up here is a dead limb
# — fix the wiring, don't grow this list.
SUBJECTS_UNPRODUCED_ALLOWED = {
    "ENGINE_EMBED_QUERY":
        "public RPC endpoint exported in the generated C++ header for "
        "remote callers; no in-repo caller by design",
    "TASKS_MEMORY_COUNT":
        "public request-reply row count that a load harness or an "
        "operator's bus client polls to confirm an ingest landed; the "
        "port's own load harness is not in the tree yet",
}

# ------------------------------------------------------------- data plane
# (file, enclosing dotted scope) pairs that may keep a per-float
# conversion: bounded, latency-path payloads (top-k scores).
FLOAT_LIST_ALLOWED = {
    ("symbiont_tpu_torch/services/engine_service.py",
     "EngineService._rerank.op"):
        "bounded top-k score list on the latency path — a handful of "
        "floats is not a data plane",
}

# no current site may use asdict on a services/ message path; keep it that way
ASDICT_ALLOWED: dict = {}

# exactly one encoder may map a negotiated encoding value to a dtype name;
# every other dtype decision lives in schema/frames.py
FRAME_DTYPE_ALLOWED = {
    ("symbiont_tpu_torch/services/engine_service.py",
     "EngineService._embed_batch.op"):
        "the ONE negotiated-encoding -> frame-dtype mapping site "
        "(engine-plane reply encoding: 'frame16' -> f16)",
}

# ------------------------------------------------------- async event loop
# (file, dotted scope of the ASYNC function). The fleet exporter holds a
# plain threading lock for a bounded O(spans_max) deque splice shared with
# producer THREADS (span taps fire from executor threads) — an
# asyncio.Lock cannot serve both sides, and an executor hop per splice
# would cost more than the splice.
ASYNC_BLOCKING_ALLOWED = {
    ("symbiont_tpu_torch/obs/fleet.py", "TelemetryExporter.publish_once"):
        "bounded deque splice under the tap lock shared with executor-"
        "thread span producers; never held across I/O",
    ("symbiont_tpu_torch/obs/fleet.py", "TelemetryExporter.stop"):
        "self.store here is the in-process TraceStore (flight recorder): "
        "remove_tap is an O(taps) in-memory list removal, not a store "
        "backend call",
}

# --------------------------------------------------------------- lock order
# canonical cycle strings the analysis flags but a dynamic guard makes
# safe. Empty: the port has no known ordering cycles — keep it that way.
LOCK_ORDER_ALLOWED: dict = {}

# ------------------------------------------------------------ torch hygiene
# executable-cache builders: a CUDA graph recorded here is keyed and cached
# by signature — each signature captures once, by design.
TORCH_GRAPH_CAPTURE_ALLOWED = {
    ("symbiont_tpu_torch/graphs.py", "Executable.capture"):
        "THE executable cache's capture: one CUDA graph per Executable, "
        "made on its first call under _first_lock and kept by ExecCache "
        "per (kind, length-bucket, batch-bucket) key, LRU-bounded — each "
        "signature captures exactly once",
}

# deliberate device→host syncs on the serving path: one fetch per
# dispatched call, group, chunk or round, never per row. This table IS the
# inventory of every host sync on the port's serving path: each scope is a
# series of engine.host_syncs_total{site} (obs/xprof.known_sync_sites()),
# and each site counts its fetches through dispatch_ledger.note_host_sync.
# A new entry means a new sync point was added on purpose.
TORCH_HOST_SYNC_ALLOWED = {
    ("symbiont_tpu_torch/engine/engine.py", "TorchEngine.embed_texts"):
        "one bulk fetch per concat GROUP (not per batch) in _fetch: every "
        "group's non-blocking copy starts before one event wait, so the "
        "d2h copies overlap",
    ("symbiont_tpu_torch/engine/engine.py", "TorchEngine.rerank"):
        "the rerank batches' scores come back through the same grouped "
        "_fetch as embed_texts — one wait per call, never per row",
    ("symbiont_tpu_torch/engine/engine.py", "TorchEngine.embed_and_search"):
        "the fused query returns k scores and ids to the caller: one wait "
        "on their non-blocking copies per query is the answer itself",
    ("symbiont_tpu_torch/engine/engine.py", "TorchEngine.warmup"):
        "warmup exists to FORCE the capture+replay to finish; the sync is "
        "the point, and the path never serves traffic",
    ("symbiont_tpu_torch/engine/lm.py", "LmEngine.generate_batch"):
        "a non-streaming batch answers once: one fetch of every row's "
        "tokens and lengths after the whole decode",
    ("symbiont_tpu_torch/engine/lm.py", "LmEngine._generate_stream_impl"):
        "chunk-boundary sync is the streaming contract: each decoded "
        "chunk's (or speculative round's) tokens must reach the SSE reader "
        "before the next chunk decodes (stream_chunk bounds the cadence)",
    ("symbiont_tpu_torch/engine/lm.py", "BatchSession.__init__"):
        "a paged session start with the radix cache on commits its prompt "
        "blocks with their last logits on the host: one [rows, vocab] "
        "fetch per start, so the next admission with the prefix skips its "
        "prefill",
    ("symbiont_tpu_torch/engine/lm.py", "BatchSession.splice"):
        "the radix commit of a splice's admitted rows, as at the start: one "
        "[rows, vocab] logits fetch per admission splice",
    ("symbiont_tpu_torch/engine/lm.py", "BatchSession._step_plain"):
        "chunk-boundary sync of continuous batching: the chunk's tokens "
        "must reach the host to finish rows, free their slots and admit "
        "newcomers before the next chunk",
    ("symbiont_tpu_torch/engine/lm.py", "BatchSession._step_spec"):
        "the speculative round's one fetch (accepted tokens, counts, "
        "emitted): the host needs them to advance rows before the next "
        "draft",
}

# rule/table registry the engine consults (allow_key -> {entry: reason})
ALLOWLISTS = {
    "subject-unproduced": SUBJECTS_UNPRODUCED_ALLOWED,
    "no-per-float-conversion": FLOAT_LIST_ALLOWED,
    "no-asdict-on-ingest": ASDICT_ALLOWED,
    "no-hardcoded-frame-dtype": FRAME_DTYPE_ALLOWED,
    "async-blocking-call": ASYNC_BLOCKING_ALLOWED,
    "lock-order": LOCK_ORDER_ALLOWED,
    "graph-capture-in-function": TORCH_GRAPH_CAPTURE_ALLOWED,
    "torch-host-sync-in-loop": TORCH_HOST_SYNC_ALLOWED,
}
