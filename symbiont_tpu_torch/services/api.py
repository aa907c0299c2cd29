"""API gateway — HTTP + SSE frontend, bus client behind.

Copy of the JAX package's `symbiont_tpu/services/api.py`, with its obs
routes on the port's obs modules: `/api/engine/executables` serves the
dispatch ledger's rows, each graded on the roofline from its capture's
cost (`obs/xprof.py`), `/api/memory/census` the live-tensor census
(`obs/hbm.py`) and `POST /api/profile/device` a bounded `torch.profiler`
trace (`obs/xprof.DeviceTraceCapture`).

Parity with reference: services/api_service/src/main.rs (§1-L4 contract —
the reference's Next.js frontend works against this unmodified):

- POST /api/submit-url      → publish tasks.perceive.url (main.rs:42-111)
- POST /api/generate-text   → validate task_id/max_length 1..=1000, publish
                              tasks.generation.text (main.rs:113-188)
- GET  /api/events          → SSE stream of events.text.generated with 15s
                              keep-alive, drop-on-lag (main.rs:190-270)
- POST /api/search/semantic → 2-hop request-reply orchestration with 15s/20s
                              timeouts and the reference's exact status-code /
                              error-body mapping (main.rs:272-512)
- CORS on localhost origins (main.rs:555-567)

Additions (SURVEY.md §5.5/§5.3 plans): GET /api/metrics (JSON snapshot),
GET /metrics (Prometheus text exposition; OpenMetrics with exemplars when
negotiated), GET /healthz, and the flight-recorder query surface:
GET /api/traces/recent, GET /api/traces/<trace_id> (span tree),
GET /api/traces/<trace_id>/critical_path (latency attribution,
obs/critical_path.py) and GET /api/traces/<trace_id>/export?fmt=chrome
(Perfetto-loadable Chrome Trace Format, obs/chrome_trace.py).

Server: stdlib asyncio HTTP/1.1 — no web framework; this is the Python twin of
the native C++ gateway under native/.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.config import ApiConfig, BusConfig
from symbiont_tpu_torch.schema import (
    GenerateTextTask,
    QueryEmbeddingResult,
    QueryForEmbeddingTask,
    SemanticSearchApiRequest,
    SemanticSearchApiResponse,
    SemanticSearchNatsResult,
    SemanticSearchNatsTask,
    from_dict,
    from_json,
    to_json,
    to_json_bytes,
)
from symbiont_tpu_torch.schema import frames
from symbiont_tpu_torch.resilience import admission as adm
from symbiont_tpu_torch.resilience.admission import (
    AdmissionController,
    AdmissionReject,
    DegradationLadder,
)
from symbiont_tpu_torch.utils.ids import generate_uuid
from symbiont_tpu_torch.utils.telemetry import (
    DEADLINE_HEADER,
    SPAN_HEADER,
    TENANT_HEADER,
    TRACE_HEADER,
    metrics,
    new_trace_headers,
    span,
)

log = logging.getLogger(__name__)

import re

# exact host (+optional port): http://localhost.evil.com must NOT match
_ORIGIN_RE = re.compile(r"^https?://(localhost|127\.0\.0\.1)(:\d+)?$")

_LAGGED = object()  # queue sentinel: this client fell behind → terminal close


class _HttpError(Exception):
    """Malformed/oversized request — answered with a status, then close.

    Carries the request Origin (headers are parsed before the body checks
    fire) so the error response gets CORS headers — a browser client must be
    able to read the 413/400, same as the C++ twin."""

    def __init__(self, status: int, message: str, origin: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.origin = origin


def _deadline_capped(default_s: float, headers: Dict[str, str]) -> float:
    """A bus-request timeout never longer than the request's remaining
    deadline budget: downstream services drop expired deliveries WITHOUT
    replying, so waiting out the full transport timeout would pin a fair-
    queue slot for dead work — up to 2x the deadline — exactly when
    shedding should be freeing capacity. Floor keeps a just-expiring
    request failing fast instead of with timeout=0 weirdness."""
    rem = adm.remaining_ms(headers)
    if rem is None:
        return default_s
    return max(0.05, min(default_s, rem / 1000.0))


@contextlib.asynccontextmanager
async def _fair_slot(admission, tenant: str):
    """Hold one weighted-fair search-concurrency slot for the block (no-op
    without an admission controller); released on every exit path."""
    if admission is not None:
        await admission.fair_queue.acquire(tenant)
    try:
        yield
    finally:
        if admission is not None:
            admission.fair_queue.release(tenant)


class _SseClient:
    __slots__ = ("q", "want", "lagged")

    def __init__(self, capacity: int, want: Optional[str]):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=capacity)
        self.want = want      # task_id filter (None = receive everything)
        self.lagged = False   # fell behind; terminal close pending


class _SseHub:
    """Bounded broadcast: capacity-32 queues (reference: broadcast channel
    cap 32, main.rs:537) — but a lagged client gets an explicit terminal
    `retry:` + error close instead of the reference's silent message drop
    (main.rs:201-209), so a slow reader KNOWS its stream has a gap and can
    reconnect with Last-Event-ID instead of serving truncated text.

    Clients may register with a task_id filter (?task_id= on /api/events):
    the reference broadcasts every generation event to every SSE client
    (main.rs:215-270 — its UI correlates by original_task_id client-side);
    unfiltered clients keep that behavior, filtered ones receive only their
    task's events.

    Exactly-once edge (docs/RESILIENCE.md "Durable generation sessions"):
    an adopted resume replays its last journaled chunk under the chunk's
    ORIGINAL seq, so a crash between journal-append and delivery loses
    nothing — and the hub drops anything at-or-below the highest seq already
    delivered for that task, so the overlap case duplicates nothing either.
    Delivered chunks are stamped `id: <task_id>:<seq>` on the wire and kept
    in a bounded per-task history; a reconnecting client's Last-Event-ID
    replays the tail it missed. Both maps are bounded, oldest task out."""

    def __init__(self, capacity: int = 32, history_tasks: int = 256,
                 history_events: int = 128):
        self.capacity = capacity
        self._clients: List[_SseClient] = []
        self._last_seq: "OrderedDict[str, int]" = OrderedDict()
        # task_id → deque[(seq, payload, done)] of delivered chunks
        self._history: "OrderedDict[str, deque]" = OrderedDict()
        self._history_tasks = history_tasks
        self._history_events = history_events

    def register(self, task_id: Optional[str] = None,
                 last_event_id: Optional[str] = None) -> _SseClient:
        c = _SseClient(self.capacity, task_id)
        if last_event_id:
            # Last-Event-ID: "<task_id>:<seq>" → replay the missed tail
            # from history before any live event (queue is empty here, so
            # ordering holds; replay is capped at queue capacity — a gap
            # larger than that closes-with-retry like any other lag).
            tid, _, seq_s = last_event_id.rpartition(":")
            try:
                after = int(seq_s)
            except ValueError:
                tid = None
            if tid and (task_id is None or tid == task_id):
                tail = [e for e in self._history.get(tid, ())
                        if e[0] > after][-self.capacity:]
                for seq, payload, done in tail:
                    c.q.put_nowait((payload, f"{tid}:{seq}", done))
                if tail:
                    metrics.inc("api.sse_replayed", len(tail))
        self._clients.append(c)
        return c

    def unregister(self, client: _SseClient) -> None:
        self._clients = [c for c in self._clients if c is not client]

    def has_follower(self, task_id: str) -> bool:
        """Any remaining client that would receive this task's events — a
        client filtered on it, or an unfiltered (receive-everything)
        reference-style client. Consulted before cancelling a generation
        on disconnect: one of several readers leaving must not kill the
        stream for the rest."""
        return any(c.want is None or c.want == task_id
                   for c in self._clients)

    def broadcast(self, payload: str) -> None:
        tid = seq = None
        done = False
        try:
            obj = json.loads(payload)
            tid = obj.get("original_task_id")
            seq = obj.get("seq")
            done = obj.get("done") is True or "generated_text" in obj
        except (ValueError, AttributeError):
            obj = None
        sse_id = None
        if tid is not None and seq is not None:
            seq = int(seq)
            last = self._last_seq.get(tid)
            if last is not None and seq <= last:
                # resume replay of an already-delivered chunk (or the
                # requeue race after a pressure-refused adoption): the
                # exactly-once guarantee lives HERE
                metrics.inc("api.sse_deduped")
                return
            self._last_seq[tid] = seq
            self._last_seq.move_to_end(tid)
            while len(self._last_seq) > self._history_tasks:
                self._last_seq.popitem(last=False)
            hist = self._history.get(tid)
            if hist is None:
                hist = self._history[tid] = deque(
                    maxlen=self._history_events)
            self._history.move_to_end(tid)
            while len(self._history) > self._history_tasks:
                self._history.popitem(last=False)
            hist.append((seq, payload, done))
            sse_id = f"{tid}:{seq}"
        item = (payload, sse_id, done)
        for c in list(self._clients):
            if c.want is not None and tid != c.want:
                continue  # not this client's task
            if c.lagged:
                continue  # terminal close already pending
            try:
                c.q.put_nowait(item)
            except asyncio.QueueFull:
                metrics.inc("api.sse_dropped")
                log.warning("SSE client lagged; closing with retry hint")
                c.lagged = True
                # make room, then wake the handler with the lag verdict
                # (same pop-one-put trick as close_all)
                try:
                    c.q.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    c.q.put_nowait(_LAGGED)
                except asyncio.QueueFull:
                    pass

    def close_all(self) -> None:
        """Wake every SSE handler with a close sentinel (None) so graceful
        shutdown doesn't deadlock in Server.wait_closed() behind permanently
        connected clients."""
        for c in list(self._clients):
            try:
                c.q.put_nowait(None)
            except asyncio.QueueFull:
                try:
                    c.q.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                try:
                    c.q.put_nowait(None)
                except asyncio.QueueFull:
                    pass


class ApiService:
    name = "api"

    def __init__(self, bus, config: Optional[ApiConfig] = None,
                 bus_config: Optional[BusConfig] = None,
                 admission: Optional[AdmissionController] = None,
                 ladder: Optional[DegradationLadder] = None,
                 gen_capacity=None, admission_config=None,
                 defer_ready: bool = False):
        self.bus = bus
        self.config = config or ApiConfig()
        self.bus_config = bus_config or BusConfig()
        self.hub = _SseHub(self.config.sse_channel_capacity)
        # overload-protection plane (resilience/admission.py, wired by the
        # runner): per-tenant quotas + weighted-fair search scheduling
        # (None = no admission control, the pre-plane behavior standalone
        # test gateways keep), the SLO shed ladder, and the LM-capacity
        # probe consulted before accepting a generation stream
        self.admission = admission
        self.ladder = ladder
        self.gen_capacity = gen_capacity  # () -> bool; None = unbounded
        self.admission_config = admission_config  # deadline budgets
        # readiness (GET /readyz): False until the hosting process says its
        # engines are placed — load balancers must not route to a cold
        # process. Standalone gateways flip ready at start() (there is
        # nothing to warm); the runner defers and calls mark_ready() once
        # the whole stack is up.
        self._ready = False
        self._defer_ready = defer_ready
        # generation task ids THIS gateway accepted (bounded, oldest out):
        # an SSE disconnect only cancels tasks known to exist — a reader
        # that pre-connected with a client-minted id and dropped before
        # ever POSTing must not tombstone the id downstream
        self._gen_submitted: dict = {}
        # fleet telemetry plane (obs/fleet.py): the runner attaches a
        # FleetAggregator in supervised deployments — /metrics then serves
        # the role-labeled federated exposition and GET /api/fleet the
        # per-role roll-up; None keeps the pre-fleet single-process surface
        # byte-identical
        self.fleet = None
        # negative cache for the fused-search subject: after a timeout
        # (subject unserved — engine and store not co-located), skip the
        # fused attempt for a window instead of stalling every request
        self._fused_down_until = 0.0
        self._server: Optional[asyncio.AbstractServer] = None
        self._bridge_tasks: List[asyncio.Task] = []
        self._bridge_subs: List = []

    def mark_ready(self) -> None:
        self._ready = True

    def mark_not_ready(self) -> None:
        """Drain protocol: a gateway being retired flips /readyz back to
        503 (and re-engages the data-path 503 gate) so the load balancer
        routes around it before the process exits."""
        self._ready = False

    # ---------------------------------------------------------------- server

    async def start(self) -> None:
        # NATS→SSE bridge (reference: nats_to_sse_listener, main.rs:215-270);
        # streaming deltas ride the same SSE channel (clients tell the two
        # payload shapes apart by their fields)
        self._bridge_subs = [
            await self.bus.subscribe(subjects.EVENTS_TEXT_GENERATED),
            await self.bus.subscribe(subjects.EVENTS_TEXT_GENERATED_PARTIAL),
        ]

        async def bridge(sub) -> None:
            async for msg in sub:
                self.hub.broadcast(msg.data.decode("utf-8", errors="replace"))

        self._bridge_tasks = [
            asyncio.create_task(bridge(s), name="sse-bridge")
            for s in self._bridge_subs]
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.host, self.config.port)
        if not self._defer_ready:
            self._ready = True
        log.info("api listening on %s:%s", self.config.host, self.config.port)

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self.hub.close_all()  # unblock SSE handlers before wait_closed
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for sub in self._bridge_subs:
            sub.close()
        for task in self._bridge_tasks:
            task.cancel()

    # ------------------------------------------------------------- plumbing

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except _HttpError as e:
                    # a well-behaved client gets a status, not a dropped
                    # socket (reference error-shape conventions)
                    await self._write_response(
                        writer, e.status,
                        json.dumps({"status": "error", "message": e.message}),
                        origin=e.origin, keep_alive=False)
                    # discard any in-flight body (bounded) before closing:
                    # an immediate close with unread bytes pending RSTs the
                    # socket and can destroy the queued response client-side
                    try:
                        deadline = asyncio.get_running_loop().time() + 1.0
                        for _ in range(64):
                            left = deadline - asyncio.get_running_loop().time()
                            if left <= 0:
                                break
                            chunk = await asyncio.wait_for(
                                reader.read(65536), left)
                            if not chunk:
                                break
                    except (asyncio.TimeoutError, OSError):
                        pass
                    break
                if request is None:
                    break
                method, path, query, headers, body = request
                keep_alive = headers.get("connection", "").lower() != "close"
                if path == "/api/events" and method == "GET":
                    await self._serve_sse(writer, headers, query)
                    return  # SSE occupies the connection
                if path == "/metrics" and method == "GET":
                    # Prometheus text exposition (scrapers want text/plain,
                    # not the /api/metrics JSON snapshot). A scraper that
                    # negotiates OpenMetrics gets that flavor — same
                    # families plus exemplars on histogram buckets. With a
                    # FleetAggregator attached (obs/fleet.py, wired by the
                    # runner in supervised deployments) the exposition is
                    # FEDERATED: every role's series in one scrape, each
                    # labeled with the role that produced it.
                    from symbiont_tpu_torch.obs import prometheus

                    om = ("application/openmetrics-text"
                          in headers.get("accept", ""))
                    if self.fleet is not None:
                        body = self.fleet.render_exposition(openmetrics=om)
                    else:
                        body = prometheus.render(openmetrics=om)
                    await self._write_response(
                        writer, 200, body,
                        origin=headers.get("origin"),
                        content_type=(prometheus.CONTENT_TYPE_OPENMETRICS
                                      if om else
                                      prometheus.CONTENT_TYPE_PROM),
                        keep_alive=keep_alive)
                    if not keep_alive:
                        break
                    continue
                if path in ("/", "/index.html") and method == "GET":
                    html = _frontend_html()
                    if html is not None:
                        await self._write_response(
                            writer, 200, html, origin=headers.get("origin"),
                            content_type="text/html; charset=utf-8",
                            keep_alive=keep_alive)
                        if not keep_alive:
                            break
                        continue
                routed = await self._route(method, path, query,
                                           headers, body)
                status, payload = routed[0], routed[1]
                # optional third element: extra response headers (e.g.
                # Retry-After on a 429 from the admission plane)
                extra = routed[2] if len(routed) > 2 else None
                await self._write_response(writer, status, payload,
                                           origin=headers.get("origin"),
                                           keep_alive=keep_alive,
                                           extra_headers=extra)
                if not keep_alive:
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError, BrokenPipeError):
            pass
        except Exception:
            log.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
        try:
            line = await reader.readline()
        except (ConnectionResetError, asyncio.LimitOverrunError):
            return None
        if not line:
            return None
        try:
            method, path, _version = line.decode("latin-1").strip().split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if b":" in h:
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
        body = b""
        origin = headers.get("origin")
        try:
            n = int(headers.get("content-length", 0) or 0)
        except ValueError:
            raise _HttpError(400, "invalid Content-Length", origin)
        # C++ twin parity (api_gateway.cpp): cap the client-supplied length —
        # negative wraps and huge values would OOM the process
        if n < 0:
            raise _HttpError(400, "invalid Content-Length", origin)
        if n > 16 * 1024 * 1024:
            raise _HttpError(413, "request body exceeds 16MB limit", origin)
        if n:
            body = await reader.readexactly(n)
        path, _, query = path.partition("?")
        return method, path, query, headers, body

    def _cors(self, origin: Optional[str]) -> str:
        # reference allows localhost/127.0.0.1 origins (main.rs:555-567)
        if origin and _ORIGIN_RE.match(origin):
            return (f"Access-Control-Allow-Origin: {origin}\r\n"
                    "Access-Control-Allow-Methods: GET, POST, OPTIONS\r\n"
                    "Access-Control-Allow-Headers: Content-Type\r\n"
                    "Vary: Origin\r\n")
        return ""

    async def _write_response(self, writer, status: int, payload: str,
                              origin: Optional[str] = None,
                              content_type: str = "application/json",
                              keep_alive: bool = True,
                              extra_headers: Optional[Dict[str, str]] = None
                              ) -> None:
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   405: "Method Not Allowed", 413: "Payload Too Large",
                   429: "Too Many Requests",
                   500: "Internal Server Error", 501: "Not Implemented",
                   503: "Service Unavailable"}
        body = payload.encode("utf-8")
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        head = (f"HTTP/1.1 {status} {reasons.get(status, 'OK')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{self._cors(origin)}"
                f"{extra}"
                f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n")
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    # --------------------------------------------------------------- routes

    async def _route(self, method: str, path: str, query: str,
                     headers: Dict[str, str],
                     body: bytes) -> Tuple[int, str]:
        if method == "OPTIONS":
            return 200, ""
        if (not self._ready and method == "POST"
                and path in ("/api/submit-url", "/api/generate-text",
                             "/api/search/semantic", "/api/search/graph")):
            # the port opens BEFORE the stack's services subscribe (so
            # /healthz and /readyz answer during engine warm-up): accepting
            # data-path work now would 200 into a bus with no consumers —
            # silent loss. Refuse honestly; a well-behaved LB watches
            # /readyz and never sends this.
            metrics.inc("api.not_ready_rejects")
            return 503, json.dumps(
                {"message": "stack is warming up (see /readyz)",
                 "task_id": None}), {"Retry-After": "1"}
        try:
            if path == "/api/submit-url" and method == "POST":
                metrics.inc("api.POST./api/submit-url")
                return await self._submit_url(body, headers)
            if path == "/api/generate-text" and method == "POST":
                metrics.inc("api.POST./api/generate-text")
                return await self._generate_text(body, headers)
            if path == "/api/search/semantic" and method == "POST":
                metrics.inc("api.POST./api/search/semantic")
                return await self._semantic_search(body, headers)
            if path == "/api/search/graph" and method == "POST":
                metrics.inc("api.POST./api/search/graph")
                return await self._graph_search(body, headers)
            if path == "/api/metrics" and method == "GET":
                return 200, json.dumps(metrics.snapshot())
            if path == "/api/traces/recent" and method == "GET":
                from symbiont_tpu_torch.obs.trace_store import trace_store

                return 200, json.dumps({"traces": trace_store.recent()})
            if path.startswith("/api/traces/") and method == "GET":
                return self._trace_route(path[len("/api/traces/"):], query)
            if path == "/api/engine/timeline" and method == "GET":
                # decode-plane flight recorder (obs/engine_timeline.py):
                # JSON summary by default; ?fmt=chrome renders Perfetto
                # counter tracks interleaved with the flight recorder's
                # engine span lanes on one time axis
                return self._engine_timeline(query)
            if path == "/api/engine/executables" and method == "GET":
                # compute-plane profiler (obs/xprof.py): per-executable
                # dispatch counts + host wall, placed on the roofline from
                # the XLA cost model captured at compile time
                return self._engine_executables()
            if path == "/api/memory" and method == "GET":
                # hbm attribution plane (obs/hbm.py): subsystem byte
                # ledger reconciled against per-device memory_stats(),
                # fleet-federated per role when the aggregator is attached
                return self._memory()
            if path == "/api/memory/census" and method == "GET":
                # on-demand live-array census (?top=N, ?diff=1 for the
                # delta vs the previous diff baseline)
                return self._memory_census(query)
            if path == "/api/profile/device" and method == "POST":
                metrics.inc("api.POST./api/profile/device")
                return await self._profile_device(body)
            if path == "/api/tenants" and method == "GET":
                # per-tenant usage roll-up (obs/usage.py): this process's
                # ledger, plus every federated role's tenant.usage.*
                # counters when the fleet aggregator is attached
                return self._tenants_rollup()
            if path == "/api/fleet" and method == "GET":
                # per-role deployment roll-up (obs/fleet.py): telemetry
                # freshness, supervisor liveness verdicts (up / restarts /
                # hangs / heartbeat age — broker probe included), and key
                # engine gauges, one entry per role
                from symbiont_tpu_torch.obs.hbm import oom_forensics

                if self.fleet is None:
                    return 200, json.dumps(
                        {"available": False, "roles": {},
                         "last_oom": oom_forensics.last,
                         "message": ("no fleet aggregator on this process "
                                     "— single-process stack, or "
                                     "obs.fleet_export off")})
                # the local OOM verdict rides the roll-up (remote roles'
                # counts federate as counter.engine.oom_total series)
                return 200, json.dumps(
                    {"available": True, "last_oom": oom_forensics.last,
                     **self.fleet.rollup()})
            if path == "/api/dlq" and method == "GET":
                return self._dlq_list()
            if path == "/api/dlq/replay" and method == "POST":
                metrics.inc("api.POST./api/dlq/replay")
                return await self._dlq_replay(body)
            if path == "/healthz" and method == "GET":
                # liveness ONLY: the process is up and serving HTTP. Routing
                # decisions belong to /readyz — a restart loop detector must
                # not flap with engine warm-up.
                return 200, json.dumps({"status": "ok"})
            if path == "/readyz" and method == "GET":
                # readiness: 503 until the hosting process says its engine
                # params are placed and the mesh (when parallel.enabled) is
                # built — load balancers must not route to a cold process
                if self._ready:
                    return 200, json.dumps({"status": "ready"})
                return 503, json.dumps(
                    {"status": "starting",
                     "message": "engine placement / mesh build in progress"})
            if path == "/api/health/engine" and method == "GET":
                return await self._engine_health()
            # one bucket for everything unmatched: arbitrary scanner paths
            # must not create unbounded counter cardinality
            metrics.inc("api.unmatched")
            return 404, json.dumps({"message": "not found", "task_id": None})
        except AdmissionReject as e:
            # overload answer: bounded refusal with a retry hint, never an
            # unbounded queue (resilience/admission.py; the Retry-After
            # header is what well-behaved clients back off on)
            return (429,
                    json.dumps({"message": str(e), "reason": e.reason,
                                "task_id": None}),
                    adm.retry_after_header(e.retry_after_s))
        except json.JSONDecodeError as e:
            return 400, json.dumps({"message": f"invalid JSON: {e}", "task_id": None})
        except ValueError as e:
            return 400, json.dumps({"message": str(e), "task_id": None})
        except Exception:
            log.exception("route %s failed", path)
            return 500, json.dumps({"message": "internal error", "task_id": None})

    def _trace_route(self, rest: str, query: str) -> Tuple[int, str]:
        """The flight-recorder query surface under /api/traces/<trace_id>:

        - ``…/<id>``                → parent-linked span tree
        - ``…/<id>/critical_path`` → blocking chain + self-time attribution
                                      + dominant-hop verdict
        - ``…/<id>/export?fmt=chrome`` → Chrome Trace Format JSON (load in
                                      Perfetto / chrome://tracing)
        """
        from urllib.parse import parse_qs

        from symbiont_tpu_torch.obs.trace_store import trace_store

        trace_id, _, sub = rest.partition("/")
        not_found = (404, json.dumps(
            {"message": "trace not found (evicted from the flight "
                        "recorder, or never recorded)", "task_id": None}))
        if sub == "":
            tree = trace_store.trace_tree(trace_id)
            return not_found if tree is None else (200, json.dumps(tree))
        if sub == "critical_path":
            from symbiont_tpu_torch.obs import critical_path

            report = critical_path.compute(trace_store, trace_id)
            return not_found if report is None else (200, json.dumps(report))
        if sub == "export":
            fmt = (parse_qs(query).get("fmt") or ["chrome"])[0]
            if fmt != "chrome":
                return 400, json.dumps(
                    {"message": f"unknown export format {fmt!r} "
                                "(supported: chrome)", "task_id": None})
            from symbiont_tpu_torch.obs import chrome_trace

            spans = trace_store.spans_for(trace_id)
            if not spans:
                return not_found
            return 200, json.dumps(chrome_trace.export_spans(trace_id,
                                                             spans))
        return 404, json.dumps({"message": "not found", "task_id": None})

    # engine-shaped span lanes the timeline export interleaves with its
    # counter tracks (first dot-segment of the span name)
    _TIMELINE_SERVICES = ("engine", "lm", "text_generator")

    def _engine_timeline(self, query: str) -> Tuple[int, str]:
        """``GET /api/engine/timeline``: the decode-plane flight recorder's
        summary (occupancy, stranded KV, prefix share, TTFT/TPOT, dominant
        stall) or, with ``?fmt=chrome``, a Perfetto-loadable document whose
        counter tracks ride the same time axis as the engine span lanes."""
        from urllib.parse import parse_qs

        from symbiont_tpu_torch.obs import chrome_trace
        from symbiont_tpu_torch.obs.engine_timeline import engine_timeline
        from symbiont_tpu_torch.obs.trace_store import trace_store

        fmt = (parse_qs(query).get("fmt") or ["json"])[0]
        events = engine_timeline.events()
        if fmt == "json":
            return 200, json.dumps({
                "summary": engine_timeline.summary(),
                "events": events[-256:],
            })
        if fmt != "chrome":
            return 400, json.dumps(
                {"message": f"unknown timeline format {fmt!r} "
                            "(supported: json, chrome)", "task_id": None})
        if not events:
            return 404, json.dumps(
                {"message": "no engine timeline recorded yet — drive some "
                            "embed/decode traffic first", "task_id": None})
        t0 = min(e["t"] for e in events) - 1.0
        t1 = max(e["t"] for e in events) + 1.0
        spans = []
        for trace_spans in trace_store.spans_by_trace().values():
            for r in trace_spans:
                if (chrome_trace.service_of(r.name) in self._TIMELINE_SERVICES
                        and t0 <= r.start_s <= t1):
                    spans.append(r)
        doc = chrome_trace.export_timeline("engine-timeline", spans, events)
        # the newest on-demand device trace, cross-linked beside the host
        # timeline (set here: chrome_trace's own output stays as it is)
        from symbiont_tpu_torch.obs.xprof import device_trace

        if device_trace.last_artifact:
            doc.setdefault("otherData", {})["device_trace_artifact"] = device_trace.last_artifact
        return 200, json.dumps(doc)

    def _engine_executables(self) -> Tuple[int, str]:
        """``GET /api/engine/executables``: the dispatch ledger's
        per-signature rows (dispatches, captures, host wall, each
        executable's cost and memory from its capture) graded on the
        roofline (`obs/xprof.grade_executable`). Achieved rates divide the
        work of a dispatch by its measured host wall, so the gap to a
        device-trace number is the host's overhead."""
        from symbiont_tpu_torch.obs.xprof import device_trace, dispatch_ledger, grade_executable

        rows = dispatch_ledger.snapshot()
        for r in rows:
            r.update(grade_executable(r["flops"], r["bytes_accessed"],
                                      r["host_wall_ms"] / 1000.0, r["dispatches"]))
        return 200, json.dumps({
            "executables": rows,
            "total_dispatches": sum(r["dispatches"] for r in rows),
            "device_trace_artifact": device_trace.last_artifact,
        })

    def _memory(self) -> Tuple[int, str]:
        """``GET /api/memory``: the hbm ledger reconciled against device
        reality — per-subsystem claims, per-device bytes in use / limit,
        the unattributed residual, and the last OOM verdict. With the
        fleet aggregator attached, every remote role's ``hbm.*`` /
        ``device.bytes*`` gauges fold in per role, so the autoscaler reads
        REAL fleet-wide headroom from one endpoint."""
        import time as _time

        from symbiont_tpu_torch.obs.hbm import hbm_ledger, oom_forensics
        from symbiont_tpu_torch.obs.prometheus import parse_flat_key

        roles: Dict[str, dict] = {}
        if self.fleet is not None:
            for role, flat in self.fleet.role_snapshots().items():
                for key, v in flat.items():
                    parsed = parse_flat_key(key)
                    if parsed is None:
                        continue
                    kind, name, labels, stat = parsed
                    if (kind != "gauge" or stat is not None
                            or not (name.startswith("hbm.")
                                    or name.startswith("device.bytes")
                                    or name == "lm.hbm_headroom_bytes")):
                        continue
                    entry = roles.setdefault(role, {})
                    if name == "hbm.attributed_bytes":
                        sub = labels.get("subsystem") or "all"
                        entry.setdefault("subsystems", {})[sub] = v
                    else:
                        lbl = ",".join(f"{k}={labels[k]}"
                                       for k in sorted(labels))
                        entry.setdefault("series", {})[
                            f"{name}{{{lbl}}}" if lbl else name] = v
        return 200, json.dumps({
            "generated_at": round(_time.time(), 3),
            "local": hbm_ledger.reconcile(),
            "last_oom": oom_forensics.last,
            "roles": roles,
        })

    def _memory_census(self, query: str) -> Tuple[int, str]:
        """``GET /api/memory/census``: the live tensors grouped by (shape,
        dtype, placement) (`obs/hbm.census`), metadata only, on demand
        only. ``?top=N`` bounds the group rows (default
        obs.hbm_census_groups); ``?diff=1`` returns the delta against the
        previous diff call's census (and arms that one as the next
        baseline)."""
        from urllib.parse import parse_qs

        from symbiont_tpu_torch.obs import hbm

        q = parse_qs(query)
        try:
            top = int((q.get("top") or [hbm.hbm_ledger.census_groups])[0])
        except ValueError:
            raise ValueError("top must be an integer")
        if (q.get("diff") or ["0"])[0] not in ("0", "", "false"):
            # a diff's censuses are unbounded (top=0): a leaked group must
            # not hide inside the "(other)" fold; only the delta is bounded
            now = hbm.census(top=0)
            before, self._census_baseline = getattr(self, "_census_baseline", None), now
            summary = {k: now.get(k) for k in ("available", "arrays", "bytes_total")}
            if before is None:
                return 200, json.dumps({
                    "baseline_armed": True, "census": summary,
                    "message": ("no prior baseline — this census is now the baseline; call "
                                "?diff=1 again to see the delta")})
            return 200, json.dumps({"diff": hbm.census_diff(before, now, top=max(1, top)),
                                    "census": summary})
        return 200, json.dumps({"census": hbm.census(top=max(1, top))})

    async def _profile_device(self, body: bytes) -> Tuple[int, str]:
        """``POST /api/profile/device``: a bounded on-demand device trace
        (``{"duration_s": 1.0}``, clamped to obs.xprof_trace_max_s) and
        its artifact path (`obs/xprof.DeviceTraceCapture`). On an executor
        thread: the capture sleeps through its window; the process-wide
        profiler lock answers 409 to a second capture."""
        from symbiont_tpu_torch.obs.xprof import device_trace

        payload = json.loads(body.decode("utf-8")) if body.strip() else {}
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        duration = payload.get("duration_s", 1.0)
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, device_trace.capture, duration)
        status = {"captured": 200, "busy": 409, "error": 500}[res["status"]]
        return status, json.dumps(res)

    def _tenants_rollup(self) -> Tuple[int, str]:
        """``GET /api/tenants``: local per-tenant usage totals, plus the
        federated per-role view folded from each role's
        ``tenant.usage.*`` counters (obs/fleet.py snapshots) when this
        process hosts the fleet aggregator."""
        import time as _time

        from symbiont_tpu_torch.obs.prometheus import parse_flat_key
        from symbiont_tpu_torch.obs.usage import usage

        roles: Dict[str, dict] = {}
        if self.fleet is not None:
            for role, flat in self.fleet.role_snapshots().items():
                for key, v in flat.items():
                    parsed = parse_flat_key(key)
                    if parsed is None:
                        continue
                    kind, name, labels, stat = parsed
                    if (kind != "counter" or stat is not None
                            or not name.startswith("tenant.usage.")):
                        continue
                    tenant = labels.get("tenant") or "default"
                    roles.setdefault(role, {}).setdefault(tenant, {})[
                        name[len("tenant.usage."):]] = v
        return 200, json.dumps({
            "generated_at": round(_time.time(), 3),
            "tenants": usage.snapshot(),
            "roles": roles,
        })

    # ------------------------------------------------------- admission edge

    @staticmethod
    def _trace_ctx(headers: Optional[Dict[str, str]]):
        """Inbound HTTP trace context → span parent. A client carrying
        X-Trace-Id/X-Span-Id across calls (the RAG flow in bench/load.py:
        search → rerank → generate) gets ONE flight-recorder trace instead
        of three; absent headers keep the old mint-per-request behavior."""
        if headers and "x-trace-id" in headers:
            ctx = {TRACE_HEADER: headers["x-trace-id"]}
            if "x-span-id" in headers:
                ctx[SPAN_HEADER] = headers["x-span-id"]
            return ctx
        return None

    def _degraded_top_k(self, tenant: str, top_k: int) -> Tuple[int, bool]:
        """Ladder rung-2 clamp shared by BOTH search surfaces (semantic +
        graph): returns (possibly-clamped top_k, degraded?) and counts the
        degraded serve — degrade, don't fail, while the SLO recovers."""
        if self.ladder is None or not self.ladder.search_degraded():
            return top_k, False
        metrics.inc("admission.degraded",
                    labels={"what": "search", "tenant": tenant})
        return self.ladder.degrade_top_k(top_k), True

    def _search_slot(self, tenant: str):
        """One weighted-fair concurrency slot over the shared search
        budget (both search surfaces ride it — a storm on either cannot
        sidestep the bounded fair queue). Async context manager; a no-op
        without an admission controller."""
        return _fair_slot(self.admission, tenant)

    def _edge_admit(self, klass: str, headers: Dict[str, str],
                    priority: str = "normal") -> Tuple[str, Dict[str, str]]:
        """The one admission gate every ingress class passes: already-
        expired client deadline → reject (no bus publish); shed ladder
        (generation only; ingest is NEVER shed); per-tenant quota; LM
        capacity (generation only). Returns (tenant, headers-to-thread):
        tenant identity plus the deadline minted for this class's budget.
        Raises AdmissionReject — answered 429 + Retry-After by _route."""
        tenant = adm.tenant_of(headers)
        if self.admission is not None:
            # client-supplied header → bounded identity universe (past the
            # cap, new tenants share the overflow bucket/queue)
            tenant = self.admission.resolve_tenant(tenant)
        if adm.expired(headers):
            # the caller's own deadline has passed: doing the work (or even
            # publishing it) serves nobody
            metrics.inc("admission.expired",
                        labels={"service": self.name, "subject": "edge"})
            raise AdmissionReject(
                "deadline", retry_after_s=1.0,
                message="request deadline already expired at the edge")
        if klass == "generate":
            if self.ladder is not None:
                reason = self.ladder.shed_generation(priority)
                if reason is not None:
                    metrics.inc("admission.shed",
                                labels={"reason": reason, "tenant": tenant})
                    raise AdmissionReject(
                        reason, retry_after_s=self._shed_retry_after_s(),
                        message=f"generation shed under SLO pressure "
                                f"({reason}, priority {priority})")
            if self.gen_capacity is not None and not self.gen_capacity():
                metrics.inc("admission.shed",
                            labels={"reason": "kv_capacity",
                                    "tenant": tenant})
                raise AdmissionReject(
                    "kv_capacity", retry_after_s=2.0,
                    message="generation capacity exhausted (KV rows at "
                            "the admission bound)")
        if self.admission is not None:
            self.admission.admit(klass, tenant)  # raises on quota
        extra = {TENANT_HEADER: tenant}
        budget = 0.0
        if self.admission_config is not None:
            budget = getattr(self.admission_config, f"deadline_{klass}_ms")
        deadline = adm.mint_deadline(budget, headers)
        if deadline is not None:
            extra[DEADLINE_HEADER] = deadline
        return tenant, extra

    @staticmethod
    def _meter_search(tenant: str) -> None:
        """Usage ledger (obs/usage.py): one ADMITTED search query billed to
        its tenant — 429s never bill (refused work is not usage)."""
        from symbiont_tpu_torch.obs.usage import usage

        usage.note(tenant, search_queries=1)

    def _shed_retry_after_s(self) -> float:
        """Sheds hint a longer back-off than quota refills: the ladder only
        steps down after recovery passes × the watchdog interval."""
        return 5.0

    async def _submit_url(self, body: bytes,
                          headers: Dict[str, str]) -> Tuple[int, str]:
        data = json.loads(body)
        url = (data.get("url") or "").strip()
        if not url:
            # reference: main.rs:48-53
            return 400, json.dumps({"message": "URL cannot be empty", "task_id": None})
        _tenant, extra = self._edge_admit("ingest", headers)
        # root span of the ingest pipeline trace: every downstream handler
        # span (perception → preprocessing → vector_memory/knowledge_graph)
        # links back to this one in the flight recorder; the deadline +
        # tenant headers thread through every hop via child_headers
        with span("api.submit_url", self._trace_ctx(headers), url=url) as sp:
            await self.bus.publish(subjects.TASKS_PERCEIVE_URL,
                                   to_json_bytes_url(url),
                                   headers={**sp.headers, **extra})
        return 200, json.dumps({
            "message": f"Task to scrape URL '{url}' submitted successfully.",
            "task_id": None})

    async def _generate_text(self, body: bytes,
                             headers: Dict[str, str]) -> Tuple[int, str]:
        task = from_dict(GenerateTextTask, json.loads(body))
        if not task.task_id.strip():
            # reference: main.rs:125-131
            return 400, json.dumps({"message": "task_id cannot be empty",
                                    "task_id": None})
        if task.max_length == 0 or task.max_length > self.config.max_gen_length:
            # reference: main.rs:133-142 (bound configurable here)
            return 400, json.dumps({
                "message": f"max_length must be between 1 and {self.config.max_gen_length}",
                "task_id": task.task_id})
        # sampling overrides (our addition): bound them here so a bad value
        # fails fast at the HTTP surface, not inside the decode loop
        if task.temperature is not None and not 0.0 <= task.temperature <= 10.0:
            return 400, json.dumps({
                "message": "temperature must be between 0 and 10",
                "task_id": task.task_id})
        if task.top_k is not None and task.top_k > 100_000:
            return 400, json.dumps({
                "message": "top_k must be at most 100000",
                "task_id": task.task_id})
        priority = (headers.get("x-symbiont-priority")
                    or "normal").strip().lower()
        _tenant, extra = self._edge_admit("generate", headers,
                                          priority=priority)
        with span("api.generate_text", self._trace_ctx(headers),
                  task_id=task.task_id) as sp:
            await self.bus.publish(subjects.TASKS_GENERATION_TEXT,
                                   to_json_bytes(task),
                                   headers={**sp.headers, **extra})
        self._gen_submitted[task.task_id] = True
        while len(self._gen_submitted) > 1024:
            self._gen_submitted.pop(next(iter(self._gen_submitted)))
        return 200, json.dumps({
            "message": f"Text generation task (id: {task.task_id}) submitted successfully.",
            "task_id": task.task_id})

    async def _graph_search(self, body: bytes,
                            headers: Dict[str, str]) -> Tuple[int, str]:
        """Graph-augmented search (the un-orphaned knowledge-graph limb as
        a first-class query surface): one request-reply hop to
        tasks.search.graph.request, same admission class and status
        mapping as semantic search."""
        data = json.loads(body)
        query_text = (data.get("query_text") or "").strip()
        if not query_text:
            return 400, json.dumps({"message": "query_text cannot be empty",
                                    "task_id": None})
        try:
            top_k = int(data.get("top_k", 5))
        except (TypeError, ValueError):
            # same 400-at-the-edge contract as semantic search — a
            # malformed field is the client's error, not a 500
            return 400, json.dumps({"message": "top_k must be an integer",
                                    "task_id": None})
        tenant, extra = self._edge_admit("search", headers)
        top_k, _ = self._degraded_top_k(tenant, top_k)
        async with self._search_slot(tenant):
            # billed only once the fair-queue slot is HELD: a queue_full
            # 429 is refused work and must not bill (same stance as quota)
            self._meter_search(tenant)
            with span("api.graph_search", self._trace_ctx(headers),
                      top_k=top_k) as sp:
                try:
                    reply = await self.bus.request(
                        subjects.TASKS_SEARCH_GRAPH_REQUEST,
                        json.dumps({"query_text": query_text,
                                    "top_k": top_k}).encode(),
                        timeout=_deadline_capped(
                            self.bus_config.request_timeout_search_s,
                            extra),
                        headers={**sp.headers, **extra})
                except TimeoutError as e:
                    return 503, json.dumps({
                        "results": [],
                        "error_message":
                            f"Failed to get graph search results "
                            f"from knowledge graph service: {e}"})
        try:
            out = json.loads(reply.data)
            if not isinstance(out, dict):
                raise ValueError("reply is not a JSON object")
        except ValueError as e:
            return 500, json.dumps({
                "results": [],
                "error_message": f"bad graph search reply: {e}"})
        return (500 if out.get("error_message") else 200), json.dumps(out)

    async def _semantic_search(self, body: bytes,
                               headers: Dict[str, str]) -> Tuple[int, str]:
        """2-hop orchestration with the reference's status mapping
        (main.rs:272-512): bus timeout → 503; service-reported error → 500.

        Overload plane: per-tenant quota + a weighted-fair concurrency slot
        around the whole orchestration (a hot tenant's backlog waits in ITS
        bounded queue, everyone else's requests keep flowing), and the shed
        ladder's degraded rung clamps top-k / skips rerank instead of
        failing the request outright."""
        req = from_dict(SemanticSearchApiRequest, json.loads(body))
        request_id = generate_uuid()
        tenant, extra = self._edge_admit("search", headers)
        req.top_k, degraded = self._degraded_top_k(tenant, req.top_k)
        if degraded and req.rerank:
            # degraded also skips the cross-encoder pass: answering
            # cheaper beats failing while the SLO recovers
            req.rerank = False
        async with self._search_slot(tenant):
            # billed only once the fair-queue slot is HELD: a queue_full
            # 429 is refused work and must not bill (same stance as quota)
            self._meter_search(tenant)
            return await self._semantic_search_inner(req, request_id,
                                                     headers, extra)

    async def _semantic_search_inner(self, req, request_id: str,
                                     headers: Dict[str, str],
                                     extra: Dict[str, str]) -> Tuple[int, str]:
        def resp(results, err=None) -> str:
            return to_json(SemanticSearchApiResponse(
                search_request_id=request_id, results=results,
                error_message=err))

        with span("api.search", self._trace_ctx(headers),
                  top_k=req.top_k) as sp:
            # downstream hops publish under THIS span's context so their
            # handler spans link into the search trace; deadline + tenant
            # thread along with it
            trace = {**sp.headers, **extra}
            if self.config.fused_search:
                fused = await self._fused_search(req, trace)
                if fused is not None:
                    results, err = fused
                    if err is not None:
                        return 500, resp([], err)
                    if req.rerank and results:
                        return await self._apply_rerank(req, results, resp, trace)
                    return 200, resp(results)
                # fused subject unserved / malformed reply → 2-hop fallback
            embed_task = QueryForEmbeddingTask(request_id=request_id,
                                               text_to_embed=req.query_text)
            try:
                # frame-negotiated reply (schema/frames): the accept HEADER
                # keeps the request body byte-identical for reference-era
                # preprocessing peers, which simply ignore it and answer
                # JSON float lists — both reply forms are decoded below
                reply = await self.bus.request(
                    subjects.TASKS_EMBEDDING_FOR_QUERY,
                    to_json_bytes(embed_task),
                    timeout=_deadline_capped(
                        self.bus_config.request_timeout_embed_s, trace),
                    headers={**trace, frames.ACCEPT_FRAME_HEADER: "1"})
            except TimeoutError as e:
                return 503, resp([], f"Failed to get embedding from preprocessing service: {e}")
            reply_json, reply_rows = frames.detach_frame(reply.data,
                                                         reply.headers)
            embed_result = from_json(QueryEmbeddingResult, reply_json)
            if embed_result.error_message:
                return 500, resp([], embed_result.error_message)
            query_embedding = (reply_rows[0].tolist()
                               if reply_rows is not None and len(reply_rows)
                               else embed_result.embedding)
            if not query_embedding:
                # None OR empty: `embedding: []` is a legal frame-mode body,
                # so a reply whose frame went missing must fail clean here,
                # not as an opaque store shape error two hops later
                return 500, resp([], "embedding service returned no embedding")

            search_task = SemanticSearchNatsTask(
                request_id=request_id,
                query_embedding=query_embedding,
                top_k=req.top_k)
            try:
                reply = await self.bus.request(
                    subjects.TASKS_SEARCH_SEMANTIC_REQUEST,
                    to_json_bytes(search_task),
                    timeout=_deadline_capped(
                        self.bus_config.request_timeout_search_s, trace),
                    headers=trace)
            except TimeoutError as e:
                return 503, resp([], f"Failed to get search results from vector memory service: {e}")
            search_result = from_json(SemanticSearchNatsResult, reply.data)
            if search_result.error_message:
                return 500, resp([], search_result.error_message)
            results = search_result.results
            if req.rerank and results:
                return await self._apply_rerank(req, results, resp, trace)
            return 200, resp(results)

    # ------------------------------------------------------------------ DLQ

    def _dlq_store(self):
        """The bus-attached dead-letter quarantine (inproc durable layer).
        On broker transports quarantine lives broker-side; this surface
        reports unavailable rather than pretending it is empty."""
        return getattr(self.bus, "dlq", None)

    def _dlq_list(self) -> Tuple[int, str]:
        store = self._dlq_store()
        if store is None:
            return 200, json.dumps({
                "available": False, "size": 0, "entries": [],
                "message": ("no in-process DLQ on this bus transport — "
                            "dead letters are accounted broker-side "
                            "(stream_stats dead_lettered)")})
        return 200, json.dumps({
            "available": True, "size": len(store),
            "entries": [e.summary() for e in store.list()]})

    async def _dlq_replay(self, body: bytes) -> Tuple[int, str]:
        """Replay quarantined message(s) to their original subject —
        body {"id": N} for one entry, {"all": true} for everything. The
        replayed message re-enters the durable flow with a fresh delivery
        budget (fix the handler first)."""
        store = self._dlq_store()
        if store is None:
            return 503, json.dumps(
                {"message": "no in-process DLQ on this bus transport",
                 "replayed": 0})
        data = json.loads(body) if body else {}
        entry_id = data.get("id")
        if entry_id is None and not data.get("all"):
            return 400, json.dumps(
                {"message": 'pass {"id": N} or {"all": true}',
                 "replayed": 0})
        if entry_id is not None and not isinstance(entry_id, int):
            return 400, json.dumps(
                {"message": "id must be an integer", "replayed": 0})
        replayed = await store.replay(self.bus, entry_id)
        if entry_id is not None and replayed == 0:
            return 404, json.dumps(
                {"message": f"no DLQ entry {entry_id} (already replayed or "
                            "evicted)", "replayed": 0})
        return 200, json.dumps({"replayed": replayed})

    async def _engine_health(self) -> Tuple[int, str]:
        """Engine-plane health over HTTP: one bus round-trip to
        engine.health (backends map, model, stats, vector count) so
        operators see the whole deployment from the gateway. 503 when no
        engine plane answers."""
        try:
            reply = await self.bus.request(
                subjects.ENGINE_HEALTH, b"{}",
                timeout=self.bus_config.request_timeout_health_s,
                headers=new_trace_headers())
        except TimeoutError:
            return 503, json.dumps(
                {"ok": False, "error_message": "engine plane unreachable"})
        try:
            body = json.loads(reply.data)
            if not isinstance(body, dict):
                raise ValueError("not an object")
        except ValueError as e:
            return 500, json.dumps(
                {"ok": False, "error_message": f"bad engine health reply: {e}"})
        if body.get("error_message"):
            # the health op itself failed (e.g. external store down) — a
            # status-based monitor must see that as unhealthy, not 200
            body.setdefault("ok", False)
            return 500, json.dumps(body)
        return 200, json.dumps(body)

    async def _fused_search(self, req: SemanticSearchApiRequest, trace):
        """Try the fused embed+top-k engine hop (one device round-trip).
        Returns (results, error) on a served reply, or None to signal
        fallback to the 2-hop orchestration (subject unserved within the
        short timeout, or malformed reply). A timeout negative-caches the
        subject for fused_search_down_s so a deployment without a co-located
        engine+store pays the probe once per window, not per request."""
        import time as _time

        from symbiont_tpu_torch.schema import QdrantPointPayload, SemanticSearchResultItem

        if _time.monotonic() < self._fused_down_until:
            return None
        if req.top_k > self.config.fused_search_max_top_k:
            # fused executables are pre-warmed for the k≤16 buckets only; a
            # larger k would pay a cold XLA compile inside the probe timeout
            # AND trip the negative cache for everyone — take the 2-hop path
            metrics.inc("api.fused_search_skipped_large_k")
            return None
        try:
            reply = await self.bus.request(
                subjects.ENGINE_QUERY_SEARCH,
                json.dumps({"text": req.query_text,
                            "top_k": req.top_k}).encode(),
                timeout=self.config.fused_search_timeout_s,
                headers=trace)
        except TimeoutError:
            self._fused_down_until = (_time.monotonic()
                                      + self.config.fused_search_down_s)
            metrics.inc("api.fused_search_fallback")
            return None
        try:
            rr = json.loads(reply.data)
            if not isinstance(rr, dict):
                raise ValueError("reply is not a JSON object")
            if rr.get("error_message"):
                return [], rr["error_message"]
            results = [
                SemanticSearchResultItem(
                    qdrant_point_id=h["id"], score=float(h["score"]),
                    payload=QdrantPointPayload(**h["payload"]))
                for h in rr["hits"]
            ]
            metrics.inc("api.fused_search")
            return results, None
        except (ValueError, TypeError, KeyError) as e:
            log.warning("bad fused-search reply (%s); falling back to 2-hop", e)
            metrics.inc("api.fused_search_fallback")
            return None

    async def _apply_rerank(self, req, results, resp, trace) -> Tuple[int, str]:
        """Third hop (our addition, BASELINE.md #4): cross-encoder rerank of
        the top-k hits; scores become CE relevance logits."""
        rerank_req = {"query": req.query_text,
                      "passages": [r.payload.sentence_text for r in results]}
        try:
            reply = await self.bus.request(
                subjects.ENGINE_RERANK,
                json.dumps(rerank_req).encode(),
                timeout=self.bus_config.request_timeout_rerank_s,
                headers=trace)
        except TimeoutError as e:
            return 503, resp([], f"Failed to get rerank scores from engine service: {e}")
        try:
            rr = json.loads(reply.data)
            if not isinstance(rr, dict):
                raise ValueError("reply is not a JSON object")
            if rr.get("error_message"):
                return 500, resp([], rr["error_message"])
            scores = rr.get("scores")
            if not isinstance(scores, list) or len(scores) != len(results):
                # C++ twin parity (api_gateway.cpp): a short score list
                # must not silently mix cosine and CE scales
                raise ValueError("score count mismatch")
            for r, s in zip(results, scores):
                r.score = float(s)
        except (ValueError, TypeError) as e:
            return 500, resp([], f"bad rerank reply: {e}")
        results = sorted(results, key=lambda r: r.score, reverse=True)
        return 200, resp(results)

    # ------------------------------------------------------------------ SSE

    async def _serve_sse(self, writer, headers: Dict[str, str],
                         query: str = "") -> None:
        """SSE with 15s keep-alive comments (reference: main.rs:190-213).
        ?task_id=<id> opts into per-task routing (see _SseHub)."""
        from urllib.parse import parse_qs

        origin = headers.get("origin")
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                f"{self._cors(origin)}"
                "Connection: keep-alive\r\n\r\n")
        writer.write(head.encode("latin-1"))
        await writer.drain()
        task_filter = (parse_qs(query).get("task_id") or [None])[0] or None
        client = self.hub.register(task_filter,
                                   headers.get("last-event-id"))
        q = client.q
        # live-connection GAUGE (decremented on disconnect below) plus a
        # cumulative counter — the pre-obs `api.sse_clients` counter only
        # ever incremented, so it silently read as "clients currently
        # connected" while actually counting connects-ever
        metrics.gauge_add("api.sse_clients", 1)
        metrics.inc("api.sse_clients_total")
        shutdown = False
        completed = False  # saw the task's done-chunk / final message
        try:
            while True:
                try:
                    item = await asyncio.wait_for(
                        q.get(), timeout=self.config.sse_keepalive_s)
                    if item is None:  # close sentinel from stop()
                        shutdown = True
                        return
                    if item is _LAGGED:
                        # this client fell behind the broadcast and has a
                        # gap: close EXPLICITLY with a retry hint so it
                        # reconnects (Last-Event-ID replays what history
                        # still holds) instead of silently serving
                        # truncated text
                        metrics.inc("api.sse_lagged_closed")
                        writer.write(b"retry: 1000\n"
                                     b"event: error\n"
                                     b'data: {"error": "client lagged; '
                                     b'reconnect to resume"}\n\n')
                        await writer.drain()
                        return
                    payload, sse_id, done = item
                    if task_filter and done:
                        completed = True
                    if sse_id:
                        # SSE event id → browsers echo it back as
                        # Last-Event-ID on auto-reconnect
                        writer.write(f"id: {sse_id}\n".encode("utf-8"))
                    for line in payload.splitlines() or [""]:
                        writer.write(f"data: {line}\n".encode("utf-8"))
                    writer.write(b"\n")
                except asyncio.TimeoutError:
                    writer.write(b": keep-alive\n\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, ConnectionAbortedError):
            pass
        finally:
            self.hub.unregister(client)
            metrics.gauge_add("api.sse_clients", -1)
            if (task_filter and not shutdown and not completed
                    and task_filter in self._gen_submitted
                    and not self.hub.has_follower(task_filter)):
                # the LAST reader of a task this gateway accepted vanished
                # MID-generation: tell the text generator so the task's
                # decode row frees at the next chunk boundary instead of
                # pinning a KV slot to budget exhaustion. A normal close
                # after the done event, a never-submitted task id, or a
                # surviving co-reader all publish nothing — the generator
                # tombstones unknown ids (the cancel-raced-ahead case), so
                # a spurious cancel would kill a live or future stream.
                metrics.inc("api.sse_gen_cancels")
                try:
                    await self.bus.publish(
                        subjects.TASKS_GENERATION_CANCEL,
                        json.dumps({"task_id": task_filter}).encode())
                except Exception:
                    log.debug("generation cancel publish failed",
                              exc_info=True)


def to_json_bytes_url(url: str) -> bytes:
    from symbiont_tpu_torch.schema import PerceiveUrlTask

    return to_json_bytes(PerceiveUrlTask(url=url))


_FRONTEND_CACHE: list = []  # [Optional[str]] — loaded once, like the C++ twin


def _frontend_html() -> Optional[str]:
    """The bundled single-page UI (frontend/index.html), if present.

    SYMBIONT_FRONTEND_PATH overrides; falling back to the repo-layout location
    next to the package. Loaded once at first use (blocking disk I/O must not
    ride the event loop per request). Returns None when not found — the
    gateway then 404s; it never fails to start (the API is fully usable
    without the UI, same as the reference where the frontend is a separate
    container, docker-compose.yml:131-145)."""
    if _FRONTEND_CACHE:
        return _FRONTEND_CACHE[0]
    import os
    from pathlib import Path

    override = os.environ.get("SYMBIONT_FRONTEND_PATH")
    candidates = ([Path(override)] if override else []) + [
        Path(__file__).resolve().parents[2] / "frontend" / "index.html"]
    html = None
    for p in candidates:
        try:
            html = p.read_text(encoding="utf-8")
            break
        except OSError:
            continue
    _FRONTEND_CACHE.append(html)
    return html
