"""Single-process runner: bus + engine + all services.

The port's counterpart of the JAX package's `symbiont_tpu/runner.py`
(ROADMAP A8): the same services, subjects, wire bytes and HTTP routes, with
`TorchEngine` (`attn_impl="flash"` puts the hand-written flash-attention
kernel under every embed flush, fused query and rerank batch) and
`LmEngine` + `GenBatcher` behind `text_generator` when `lm.enabled`. It
runs on the CUDA device unless the config asks for the CPU
(`engine.force_cpu`, `lm.force_cpu`), and never falls back to it. As in
JAX, `bus.url` picks the in-process bus or the TCP bus to a broker,
`vector_store.uri` / `graph_store.uri` the external stores behind their
breakers, `runner.role` / `runner.heartbeat_s` the fleet plane, the
heartbeats and the drain protocol of a supervised role
(resilience/procsup.py), `obs.slo_p99_ms` the SLO watchdog and
`gen_journal.enabled` the generation journal, `obs.xprof_trace_dir` and
`obs.xprof_trace_max_s` the on-demand device trace, `obs.hbm_census_groups`
the census's row bound, and `parallel` the serving mesh (below). The LM
branches not ported under a tensor-parallel mesh raise a `ValueError`
naming their ROADMAP item before anything starts (`_refuse_unported`).
`lm.ingest_train` hands `text_generator` an
`OnlineLmTrainer` (train/online.py) that fine-tunes the LM on ingested
text and syncs it into the serving engine in place.

The reference needs docker-compose with 10 containers to run at all
(reference: docker-compose.yml:1-151); this runner hosts the full pipeline in
one process over the in-proc bus (or any subset against a broker via
config.bus.url). Usage:

    python -m symbiont_tpu_torch.runner            # full stack, config from env
    SYMBIONT_API_PORT=8080 python -m symbiont_tpu_torch.runner
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import tempfile
from typing import Optional

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus import connect
from symbiont_tpu_torch.config import ObsConfig, SymbiontConfig, load_config
from symbiont_tpu_torch.engine.engine import TorchEngine
from symbiont_tpu_torch.services.api import ApiService
from symbiont_tpu_torch.services.knowledge_graph import KnowledgeGraphService
from symbiont_tpu_torch.services.perception import PerceptionService
from symbiont_tpu_torch.services.preprocessing import PreprocessingService
from symbiont_tpu_torch.services.text_generator import TextGeneratorService
from symbiont_tpu_torch.services.vector_memory import VectorMemoryService

log = logging.getLogger(__name__)


_OBS_DEFAULTS = ObsConfig()


def _refuse_unported(cfg: SymbiontConfig, mesh, builds_lm: bool) -> None:
    """The LM's tensor-parallel decision (`engine.lm.tp_decode`, JAX's
    rules) taken before any service starts, over the caller's mesh or the
    one `cfg.parallel` will build, on the LM's geometry (a checkpoint's
    config.json is read for it): a branch not ported under TP (the paged
    layout, speculative decoding, the online fine-tune) or
    `tensor_parallel="on"` where the LM cannot shard raises here, naming
    its ROADMAP item, as `LmEngine` and `OnlineLmTrainer` would raise once
    built. A caller's mesh that spans processes raises for every stack
    (serving across processes is ROADMAP's A15 multi-host serving)."""
    from symbiont_tpu_torch.parallel.mesh import axis_size, refuse_spanning

    refuse_spanning(mesh, "the runner's services")
    if not builds_lm:
        return
    from symbiont_tpu_torch.engine.lm import lm_model_config, tp_decode

    if mesh is not None:
        tp = axis_size(mesh, "tensor")
    else:
        names, shape = list(cfg.parallel.axis_names), cfg.parallel.mesh_shape
        tp = (int(shape[names.index("tensor")]) if cfg.parallel.enabled and shape is not None
              and "tensor" in names else 1)
    if tp_decode(cfg.lm, None, tp):
        tp_decode(cfg.lm, lm_model_config(cfg.lm), tp, ingest_train=cfg.lm.ingest_train)


def _mesh_on_cpu(cfg: SymbiontConfig, engine: bool, lm: bool) -> bool:
    """Whether the serving mesh is over the CPU: when every device owner
    this process builds asks for the CPU. Without CUDA and without that
    ask, the mesh is over the local devices, which cover no shape over
    more than one entry, and an engine on it raises as it does without a
    mesh: nothing serves on the CPU unasked. Owners that disagree cannot
    share one mesh over more than one entry."""
    import math

    owners = ([cfg.engine.force_cpu] if engine else []) + ([cfg.lm.force_cpu] if lm else [])
    shape = cfg.parallel.mesh_shape
    if len(set(owners)) > 1 and shape is not None and math.prod(shape) > 1:
        raise ValueError("engine.force_cpu and lm.force_cpu differ: one serving mesh "
                         f"{shape} cannot hold both")
    return bool(owners) and all(owners)


class SymbiontStack:
    """Builds and owns the full service stack; also the e2e-test harness."""

    def __init__(self, config: Optional[SymbiontConfig] = None, bus=None,
                 engine: Optional[TorchEngine] = None, mesh=None,
                 fetcher=None):
        self.config = config or load_config()
        self._bus_override = bus
        self._engine_override = engine
        self._mesh = mesh
        self._fetcher = fetcher
        self.services: list = []
        self.bus = None
        self.engine = None
        self.lm = None
        self._lm_batcher = None
        self.vector_store = None
        self.graph_store = None
        self.api: Optional[ApiService] = None
        self.watchdog = None  # obs.watchdog.SloWatchdog when configured
        self._heartbeat_task: Optional[asyncio.Task] = None
        # drain protocol (resilience/autoscale.py scale-in): flipped by a
        # `_sys.drain.<role>` message from the supervisor; `drained` wakes
        # main() so the process exits once the drain completes
        self.draining = False
        self.drained = asyncio.Event()
        self._drain_sub = None
        self._drain_task: Optional[asyncio.Task] = None
        self._hb_role = ""
        # fleet telemetry plane (obs/fleet.py): the per-role exporter and,
        # in the API-role process, the aggregator behind the federated
        # /metrics + /api/fleet surfaces
        self.fleet_exporter = None
        self.fleet = None

    KNOWN_SERVICES = {"all", "perception", "preprocessing", "vector_memory",
                      "knowledge_graph", "text_generator", "api", "engine"}

    async def start(self) -> None:
        cfg = self.config
        want = {s.strip() for s in cfg.runner.services.split(",") if s.strip()}
        unknown = want - self.KNOWN_SERVICES
        if unknown or not want:
            raise ValueError(
                f"unknown service name(s) {sorted(unknown)} in runner.services; "
                f"known: {sorted(self.KNOWN_SERVICES)}")

        def on(name: str) -> bool:
            return "all" in want or name in want

        _refuse_unported(cfg, self._mesh,
                         cfg.lm.enabled and (on("text_generator") or on("engine")))

        # observability plane (symbiont_tpu_torch/obs/): size the flight recorder,
        # apply histogram bucket bounds BEFORE any traffic observes into
        # them, register the standard process_* host gauges, and, when p99
        # thresholds are configured, run the SLO watchdog over the span
        # histograms every service handler feeds
        from symbiont_tpu_torch.obs.device import register_process_gauges
        from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
        from symbiont_tpu_torch.obs.trace_store import trace_store
        from symbiont_tpu_torch.obs.usage import usage
        from symbiont_tpu_torch.utils.telemetry import metrics

        if trace_store.capacity != cfg.obs.trace_capacity:
            trace_store.set_capacity(cfg.obs.trace_capacity)
        # tail-based retention (obs/trace_store.py): errored / SLO-breach /
        # slowest-decile traces pin into a bounded keep-set; healthy
        # traces sample at the configured rate. Gauges read the store's
        # own counters at scrape time (the store cannot import telemetry).
        trace_store.configure_retention(
            sample_rate=cfg.obs.trace_sample_rate,
            keep_traces=cfg.obs.trace_keep_traces)
        metrics.register_gauge("obs.trace_pinned_traces",
                               trace_store.pinned_traces)
        metrics.register_gauge("obs.trace_sampled_out",
                               lambda: trace_store.sampled_out)
        metrics.register_gauge("obs.trace_pin_evicted",
                               lambda: trace_store.pin_evictions)
        # decode-plane flight recorder (obs/engine_timeline.py) + the
        # per-tenant usage ledger (obs/usage.py): sized here, zero-
        # registered so the doc-drift contract covers every family at boot
        engine_timeline.configure(cfg.obs.timeline_capacity,
                                  cfg.obs.timeline_prompt_window)
        metrics.register_gauge("obs.timeline_events",
                               engine_timeline.__len__)
        usage.set_max_tenants(cfg.obs.usage_max_tenants)
        usage.register_zero()
        # compute-plane profiler (obs/xprof.py): size the per-executable
        # dispatch ledger + device-trace capture, then zero-register the
        # xla.dispatches_total / engine.host_syncs_total families so the
        # doc-drift sweep (and /metrics) sees them before any dispatch —
        # one series per allowlisted host-sync site, even if it never fires
        from symbiont_tpu_torch.obs.xprof import device_trace, dispatch_ledger
        dispatch_ledger.configure(enabled=cfg.obs.xprof_enabled,
                                  max_executables=cfg.obs.xprof_executables)
        # the default trace dir (JAX's fixed /tmp path) resolves under this
        # process's temp dir, which follows TMPDIR
        trace_dir = cfg.obs.xprof_trace_dir
        if trace_dir == _OBS_DEFAULTS.xprof_trace_dir:
            trace_dir = os.path.join(tempfile.gettempdir(), "symbiont_xprof")
        device_trace.configure(trace_dir=trace_dir, max_s=cfg.obs.xprof_trace_max_s)
        dispatch_ledger.register_zero()
        metrics.register_gauge("obs.xprof_executables",
                               dispatch_ledger.__len__)
        # hbm attribution plane (obs/hbm.py): configure the subsystem
        # byte ledger + OOM forensics, zero-register their families for
        # the doc-drift sweep. Per-claim gauges register LATER (after
        # services boot, when the engines have claimed) — see _start's
        # device-gauge block.
        from symbiont_tpu_torch.obs.hbm import hbm_ledger, oom_forensics
        hbm_ledger.configure(enabled=cfg.obs.hbm_enabled,
                             census_groups=cfg.obs.hbm_census_groups)
        # the default postmortem dir (JAX's fixed /tmp path) resolves under
        # this process's temp dir, which follows TMPDIR
        pm_dir = cfg.obs.hbm_postmortem_dir
        if pm_dir == _OBS_DEFAULTS.hbm_postmortem_dir:
            pm_dir = os.path.join(tempfile.gettempdir(), "symbiont_hbm")
        oom_forensics.configure(postmortem_dir=pm_dir,
                                max_files=cfg.obs.hbm_postmortem_max,
                                enabled=cfg.obs.hbm_enabled)
        hbm_ledger.register_zero()
        oom_forensics.register_zero()
        # kv.* page-pool/radix families at zero BEFORE the engine exists
        # (zero-returning callbacks a real PagePool later replaces) — the
        # doc-drift sweep sees them even on a stub stack with no LM
        from symbiont_tpu_torch.kv.pool import register_zero_gauges
        register_zero_gauges(cfg.lm.dtype, cfg.lm.kv_quant)
        if cfg.obs.histogram_buckets_ms:
            metrics.set_bucket_bounds(cfg.obs.histogram_buckets_ms)
        register_process_gauges()  # platform-guarded no-op off Linux
        if cfg.obs.slo_p99_ms:
            from symbiont_tpu_torch.obs.watchdog import SloWatchdog, parse_thresholds

            self.watchdog = SloWatchdog(parse_thresholds(cfg.obs.slo_p99_ms),
                                        interval_s=cfg.obs.slo_interval_s,
                                        burn_fast_s=cfg.obs.slo_burn_fast_s,
                                        burn_slow_s=cfg.obs.slo_burn_slow_s)
            self.watchdog.start()

        self.services = []
        self.bus = self._bus_override or await connect(cfg.bus.url)

        # API gateway starts FIRST (when hosted): liveness (/healthz) and
        # readiness (/readyz → 503) must answer DURING engine placement /
        # engine placement, so a load balancer keeps traffic away from a cold
        # process instead of timing out against a socket that doesn't exist
        # yet. mark_ready() flips only at the very end of start(), once
        # params are placed.
        if on("api"):
            admission_ctl = ladder = None
            if cfg.admission.enabled:
                from symbiont_tpu_torch.resilience.admission import (
                    AdmissionController,
                    DegradationLadder,
                )

                admission_ctl = AdmissionController(cfg.admission)
                # SLO-aware shedding: the watchdog's breach passes drive
                # the degradation ladder the gateway consults per request
                ladder = DegradationLadder(
                    recovery_passes=cfg.admission.shed_recovery_passes,
                    hold_s=cfg.admission.shed_hold_s,
                    degraded_top_k=cfg.admission.degraded_top_k)
                if self.watchdog is not None:
                    self.watchdog.add_listener(ladder.on_slo_pass)
            self.api = ApiService(
                self.bus, cfg.api, cfg.bus,
                admission=admission_ctl, ladder=ladder,
                # capacity-aware generation admission: consult the live
                # LM's KV-row occupancy before accepting a stream (late-
                # bound — the LM is constructed below)
                gen_capacity=(
                    (lambda: self.lm is None
                     or self.lm.can_admit(1, cfg.admission.max_kv_rows))
                    if cfg.admission.enabled else None),
                admission_config=(cfg.admission if cfg.admission.enabled
                                  else None),
                defer_ready=True)
            await self.api.start()

        # Serving mesh, as in JAX: when this process is about to construct a
        # real device engine (embed or LM) or an embedded store and no caller
        # handed a mesh in, build one from cfg.parallel — mesh_shape unset
        # means all local devices on the 'data' axis, so a multi-card host
        # serves DP out of the box and a one-card host gets an inert (1, 1)
        # mesh the engines treat as none. The same mesh reaches the vector
        # store (corpus rows split over 'data') and LmEngine (TP decode
        # when 'tensor' > 1). Stub-engine test stacks (engine override) skip
        # it: no real device work, no mesh.
        builds_real_engine = (self._engine_override is None
                              and (on("preprocessing") or on("engine")))
        builds_real_lm = cfg.lm.enabled and (on("text_generator") or on("engine"))
        builds_embedded_store = (self._engine_override is None
                                 and (on("vector_memory") or on("engine"))
                                 and not cfg.vector_store.uri
                                 and cfg.vector_store.device_resident)
        if (cfg.parallel.enabled and self._mesh is None
                and (builds_real_engine or builds_real_lm or builds_embedded_store)):
            from symbiont_tpu_torch.parallel.mesh import mesh_from_config

            self._mesh = mesh_from_config(cfg.parallel, cpu=_mesh_on_cpu(
                cfg, builds_real_engine or builds_embedded_store, builds_real_lm))
            log.info("serving mesh: %s", self._mesh.shape)
        if self._mesh is not None:
            # mesh.devices{axis}: the serving topology, readable off /metrics
            from symbiont_tpu_torch.utils.telemetry import metrics

            for axis, size in self._mesh.shape.items():
                metrics.gauge_set("mesh.devices", size, labels={"axis": str(axis)})

        # at-least-once pipeline (SURVEY.md §5.3): one durable stream captures
        # the fire-and-forget subjects; each consumer acks after its side
        # effect lands. Request-reply subjects stay core (their failure mode
        # is the caller's timeout + retry). Both the native broker AND the
        # default in-proc bus implement the stream contract now (resilience
        # plane) — bus.durable works on the single-process stack.
        pipeline_stream = None
        if cfg.bus.durable and hasattr(self.bus, "add_stream"):
            pipeline_stream = "pipeline"
            await self.bus.add_stream(
                pipeline_stream,
                [subjects.DATA_RAW_TEXT_DISCOVERED,
                 subjects.DATA_TEXT_WITH_EMBEDDINGS,
                 subjects.DATA_PROCESSED_TEXT_TOKENIZED],
                ack_wait_s=cfg.bus.durable_ack_wait_s,
                max_deliver=cfg.bus.durable_max_deliver)
        elif cfg.bus.durable:
            log.warning("bus.durable requested but transport %s has no "
                        "durable streams (use inproc:// or symbus://)",
                        cfg.bus.url)
        # size the dead-letter quarantine behind GET /api/dlq (inproc bus)
        if hasattr(self.bus, "dlq"):
            self.bus.dlq.capacity = cfg.resilience.dlq_capacity
        if on("preprocessing") or on("engine"):
            self.engine = self._engine_override or TorchEngine(cfg.engine, mesh=self._mesh)
        if on("vector_memory") or on("engine"):
            # vector store dim follows the engine's actual hidden size; in a
            # standalone vector_memory worker (no engine in-process) the
            # configured dim must match the remote engine's model
            vs_cfg = cfg.vector_store
            if self.engine and vs_cfg.dim != self.engine.model_cfg.hidden_size:
                import dataclasses

                vs_cfg = dataclasses.replace(
                    vs_cfg, dim=self.engine.model_cfg.hidden_size)
            elif self.engine is None:
                log.warning("vector store dim=%d taken from config "
                            "(no in-process engine to follow)", vs_cfg.dim)
            # uri set (or reference QDRANT_URI alias) → external Qdrant
            # backend behind its breaker; else the embedded store on the
            # engine's device (the CPU when the config asks for it and
            # there is no engine in-process)
            from symbiont_tpu_torch.memory.qdrant_backend import make_vector_store

            device = (self.engine.device if self.engine is not None
                      else ("cpu" if cfg.engine.force_cpu else None))
            self.vector_store = make_vector_store(vs_cfg, device=device,
                                                  resilience=cfg.resilience, mesh=self._mesh)
            if not on("vector_memory"):
                # engine-only deployment: VectorMemoryService isn't there to
                # run the startup ensure, so do it here (idempotent);
                # executor because external backends block on HTTP retries
                await asyncio.get_running_loop().run_in_executor(
                    None, self.vector_store.ensure_collection)
        if on("knowledge_graph") or on("engine"):
            # uri set (or reference NEO4J_URI alias) → external Neo4j backend
            from symbiont_tpu_torch.graph.neo4j_backend import make_graph_store

            self.graph_store = make_graph_store(cfg.graph_store,
                                                resilience=cfg.resilience)
            if not on("knowledge_graph"):
                await asyncio.get_running_loop().run_in_executor(
                    None, self.graph_store.ensure_schema)  # engine-only: see above

        lm_batcher = None
        if cfg.lm.enabled and (on("text_generator") or on("engine")):
            from symbiont_tpu_torch.engine.batcher import GenBatcher
            from symbiont_tpu_torch.engine.lm import LmEngine

            self.lm = LmEngine(cfg.lm, mesh=self._mesh)
            if cfg.gen_journal.enabled:
                # durable generation sessions: the engine snapshots every
                # stream at its chunk boundaries to <dir>/<role>.genlog;
                # the process supervisor republishes the tails if this
                # process dies mid-stream
                from pathlib import Path

                from symbiont_tpu_torch.resilience.genlog import GenJournal

                jrole = cfg.runner.role or "local"
                self.lm.journal = GenJournal(
                    Path(cfg.gen_journal.dir) / f"{jrole}.genlog",
                    max_bytes=cfg.gen_journal.max_bytes,
                    max_tasks=cfg.gen_journal.max_tasks,
                    fsync=cfg.gen_journal.fsync)
            # one generation micro-batcher shared by the bus surface and the
            # engine plane: concurrent requests decode as one batch. Stored
            # on self BEFORE anything else can raise, so stop() always
            # closes its task.
            lm_batcher = self._lm_batcher = GenBatcher(self.lm)
            await lm_batcher.start()

        # ONE micro-batching queue in front of the device, shared by every
        # in-process caller (preprocessing pipeline + engine.* plane) — two
        # queues would mean concurrent forwards on one engine, the hazard
        # SURVEY.md §5.2 exists to prevent
        batcher = None
        if self.engine is not None:
            from symbiont_tpu_torch.engine.batcher import MicroBatcher

            batcher = MicroBatcher(self.engine)

        if self.engine is not None or self.lm is not None:
            # device-plane memory gauges (bytes in use / peak / limit per
            # CUDA device) — only once an engine is in play; a CPU-only or
            # api-only process registers nothing
            from symbiont_tpu_torch.obs.device import register_device_gauges
            from symbiont_tpu_torch.obs.hbm import hbm_ledger

            register_device_gauges()
            # the engines/pools/corpus have claimed by now: expose the
            # ledger as hbm.attributed_bytes{subsystem} gauges (+ the
            # per-device residual where the backend reports stats)
            hbm_ledger.register_gauges()

        if on("perception"):
            self.services.append(
                PerceptionService(self.bus, cfg.perception, fetcher=self._fetcher))
        if on("preprocessing"):
            self.services.append(
                PreprocessingService(self.bus, self.engine, batcher=batcher,
                     durable_stream=pipeline_stream))
        if on("vector_memory"):
            self.services.append(VectorMemoryService(
                self.bus, self.vector_store, durable_stream=pipeline_stream,
                coalesce=cfg.vector_store.coalesce,
                coalesce_max_rows=cfg.vector_store.coalesce_max_rows,
                coalesce_max_age_ms=cfg.vector_store.coalesce_max_age_ms))
        if on("knowledge_graph"):
            self.services.append(KnowledgeGraphService(
                self.bus, self.graph_store, durable_stream=pipeline_stream))
        if on("text_generator"):
            # with the LM backend active, skip Markov ingest training — the
            # chain would grow unboundedly while never being used to generate
            lm_stream = (self.lm.generate_stream
                         if self.lm is not None and cfg.lm.stream_chunk > 0
                         else None)
            lm_trainer = None
            if self.lm is not None and cfg.lm.ingest_train:
                from symbiont_tpu_torch.train.online import OnlineLmTrainer

                lm_trainer = OnlineLmTrainer(
                    self.lm, learning_rate=cfg.lm.ingest_train_lr,
                    seq_len=cfg.lm.ingest_train_seq_len,
                    batch_size=cfg.lm.ingest_train_batch,
                    state_path=cfg.lm.train_state_path)
            self.services.append(
                TextGeneratorService(self.bus, lm_batcher=lm_batcher,
                                     lm_stream=lm_stream,
                                     train_on_ingest=lm_batcher is None,
                                     state_path=(cfg.text_generator
                                                 .markov_state_path),
                                     lm_trainer=lm_trainer,
                                     lm_train_min_chars=(
                                         cfg.lm.ingest_train_min_chars),
                                     lm_train_steps=cfg.lm.ingest_train_steps,
                                     # durability plane: the service owns
                                     # mark_done (journal entries survive
                                     # until the result is PUBLISHED) and
                                     # adopts orphaned streams republished
                                     # by the supervisor
                                     journal=(self.lm.journal
                                              if self.lm is not None
                                              else None),
                                     lm_resume=(self.lm.generate_stream
                                                if self.lm is not None
                                                else None),
                                     resume_max_attempts=(
                                         cfg.gen_journal.resume_max_attempts),
                                     resume_backoff_s=(
                                         cfg.gen_journal.resume_backoff_s)))
        if on("engine"):
            from symbiont_tpu_torch.services.engine_service import EngineService

            self.services.append(EngineService(
                self.bus, engine=self.engine, batcher=batcher, lm=self.lm,
                lm_batcher=lm_batcher,
                vector_store=self.vector_store, graph_store=self.graph_store,
                coalesce=cfg.vector_store.coalesce,
                coalesce_max_rows=cfg.vector_store.coalesce_max_rows,
                coalesce_max_age_ms=cfg.vector_store.coalesce_max_age_ms))
        for s in self.services:
            # handler timeout/retry + loop-supervisor knobs (resilience
            # plane); services may further tune their own fields after
            s.apply_resilience(cfg.resilience)
            await s.start()
        if self.api is not None:
            # everything behind the gateway is placed: flip /readyz to 200
            self.api.mark_ready()
            log.info("symbiont stack up: api on %s:%s", cfg.api.host, self.api.port)
        else:
            log.info("symbiont stack up (no api): %s", sorted(want))
        # fleet telemetry plane (obs/fleet.py): active whenever this
        # process runs as a NAMED role in a supervised deployment
        # (runner.role set, or heartbeats on) — a default single-process
        # stack keeps the pre-fleet /metrics byte-identical. The exporter
        # ships this role's metric deltas + finished spans; the API-role
        # process additionally hosts the aggregator that merges every
        # role's telemetry into the federated /metrics, the stitched
        # cross-process traces, and GET /api/fleet.
        fleet_on = (cfg.obs.fleet_export
                    and (bool(cfg.runner.role) or cfg.runner.heartbeat_s > 0))
        if fleet_on:
            from symbiont_tpu_torch.obs.fleet import (
                FleetAggregator,
                TelemetryExporter,
                subscribe_telemetry,
            )

            role = cfg.runner.role or "+".join(sorted(want))
            if self.api is not None:
                self.fleet = FleetAggregator(
                    local_role=role, max_roles=cfg.obs.fleet_roles_max)
                self.fleet.attach(await subscribe_telemetry(self.bus))
                self.api.fleet = self.fleet
            self.fleet_exporter = TelemetryExporter(
                lambda: self.bus, role=role,
                publish_s=cfg.obs.fleet_publish_s,
                spans_max=cfg.obs.fleet_spans_max,
                pending_max=cfg.obs.fleet_pending_max,
                metrics_max=cfg.obs.fleet_metrics_max,
                full_every=cfg.obs.fleet_full_every)
            self.fleet_exporter.start()
        # process-failure plane: liveness heartbeats for the supervisor
        # (resilience/procsup.py), plus the drain subscription the elastic
        # autoscaler's scale-in rides (resilience/autoscale.py). Started
        # LAST — a heartbeat promises the whole stack is placed and
        # consuming, not just that python booted.
        if cfg.runner.heartbeat_s > 0 or cfg.runner.role:
            role = self._hb_role = cfg.runner.role or "+".join(sorted(want))
            self._drain_sub = await self.bus.subscribe(
                f"{subjects.SYS_DRAIN}.{role}")
            self._drain_task = asyncio.create_task(
                self._drain_loop(), name="runner-drain")
        if cfg.runner.heartbeat_s > 0:
            self._heartbeat_task = asyncio.create_task(
                self._heartbeat_loop(self._hb_role, cfg.runner.heartbeat_s),
                name="runner-heartbeat")

    def _heartbeat_payload(self, role: str) -> bytes:
        """One liveness beat. `capacity`/`draining` are the elastic-
        autoscaler fields: capacity 1 means this replica is serving, 0
        means it is draining out and the supervisor should neither route
        hang verdicts at it nor count it as serving headroom. Keys and
        their order are BYTE-PARITY with common.hpp heartbeat_payload
        (cpp-parity lint rule + tests/test_fleet.py pin both)."""
        import json
        import os

        return json.dumps({"role": role, "pid": os.getpid(),
                           "capacity": 0 if self.draining else 1,
                           "draining": self.draining}).encode()

    async def _heartbeat_loop(self, role: str, interval_s: float) -> None:
        from symbiont_tpu_torch.utils.telemetry import metrics

        while True:
            try:
                await self.bus.publish(
                    f"{subjects.SYS_HEARTBEAT}.{role}",
                    self._heartbeat_payload(role))
                metrics.inc("runner.heartbeats", labels={"role": role})
            except ConnectionError:
                # broker gap: the TcpBus send-gate already waited its
                # bounded window; skip this beat and keep beating — the
                # supervisor treats broker-down as "don't judge workers"
                log.debug("heartbeat publish failed (bus disconnected)")
            except RuntimeError:
                return  # bus closed: stack is stopping
            await asyncio.sleep(interval_s)

    async def _drain_loop(self) -> None:
        """Wait for the supervisor's drain request and run the protocol.
        One-shot: the first `_sys.drain.<role>` message retires this
        process."""
        async for _msg in self._drain_sub:
            await self.drain()
            return

    async def drain(self) -> None:
        """The worker half of the drain protocol (scale-in,
        resilience/autoscale.py): stop pulling new durable deliveries
        (consumers detach — unacked work redelivers to surviving queue-
        group members), let in-flight handlers finish, flush the
        UpsertCoalescer (ack-after-flush waits release), finish in-flight
        generation sessions, publish a final heartbeat with
        `draining: true`, and wake main() to exit. Idempotent."""
        from symbiont_tpu_torch.utils.telemetry import metrics

        if self.draining:
            return
        self.draining = True
        metrics.gauge_set("runner.draining", 1)
        log.info("drain requested: detaching consumers and flushing")
        if self.api is not None:
            # a draining gateway goes /readyz 503 first so the LB routes
            # around it before the socket disappears
            self.api.mark_not_ready()
        for s in self.services:
            await s.drain()
        if self._lm_batcher is not None:
            # finishes in-flight generation sessions (close() runs every
            # pending flush to completion before failing the leftovers)
            await self._lm_batcher.close()
        if self._hb_role:
            try:
                # the final beat: tells the supervisor (and /api/fleet)
                # this exit is a DRAIN, not a death
                await self.bus.publish(
                    f"{subjects.SYS_HEARTBEAT}.{self._hb_role}",
                    self._heartbeat_payload(self._hb_role))
            except Exception:
                log.debug("final draining heartbeat failed", exc_info=True)
        log.info("drain complete: exiting")
        self.drained.set()

    async def stop(self) -> None:
        if self._drain_task is not None:
            self._drain_task.cancel()
            try:
                await self._drain_task
            except (asyncio.CancelledError, Exception):
                pass
            self._drain_task = None
        if self._drain_sub is not None:
            self._drain_sub.close()
            self._drain_sub = None
        if self.fleet_exporter is not None:
            await self.fleet_exporter.stop()
            self.fleet_exporter = None
        if self.fleet is not None:
            await self.fleet.detach()
            self.fleet = None
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except (asyncio.CancelledError, Exception):
                pass
            self._heartbeat_task = None
        if self.watchdog is not None:
            await self.watchdog.stop()
            self.watchdog = None
        if self.api:
            await self.api.stop()
        for s in self.services:
            await s.stop()
        if self._lm_batcher is not None:
            await self._lm_batcher.close()
        if self.graph_store:
            self.graph_store.close()
        if self.bus and self._bus_override is None:
            await self.bus.close()


async def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    stack = SymbiontStack()
    await stack.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    # exit on an operator signal OR a completed drain (the supervisor's
    # scale-in request — resilience/autoscale.py): a drained worker's last
    # act is a clean rc-0 exit, which the supervisor treats as retirement,
    # not a crash
    waits = [asyncio.ensure_future(stop.wait()),
             asyncio.ensure_future(stack.drained.wait())]
    try:
        await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
    finally:
        for w in waits:
            w.cancel()
    await stack.stop()


if __name__ == "__main__":
    asyncio.run(main())
