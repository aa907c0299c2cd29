"""Process-level fault tolerance: the supervisor that owns a multi-process
deployment.

Copy of the JAX package's `symbiont_tpu/resilience/procsup.py`.

`resilience/supervisor.py` restarts crashed asyncio LOOPS inside one
process; this module graduates the same policy to real OS processes. The
reference system's failure story ends at "one Tokio task per NATS message"
— a crashed service container is simply gone until an operator notices
(PAPER survey §2). Here a deployment is a `ProcessSupervisor` owning:

- the broker (native `symbus_broker` or `python -m symbiont_tpu_torch.bus.pybroker`
  — same wire protocol, same `.symlog` durability, see bus/pybroker.py);
- one `python -m symbiont_tpu_torch.runner` process per worker role
  (SYMBIONT_RUNNER_SERVICES picks the role's service set).

Liveness is judged on THREE signals, because each catches what the others
cannot:

- exit codes — a crashed/killed process is restarted with jittered
  exponential backoff (the supervisor.py policy, per process);
- bus heartbeats (`_sys.heartbeat.<role>`, RunnerConfig.heartbeat_s) — a
  SIGSTOPped or deadlocked worker never exits, but its heartbeats stall;
  past `heartbeat_timeout_s` the supervisor SIGKILLs and restarts it.
  Heartbeat verdicts are GATED on broker health: when the broker itself is
  down, nobody's heartbeats flow, and killing healthy workers for it would
  turn one failure into seven;
- a broker PING probe (raw socket, PONG within a deadline) — the broker
  publishes no heartbeats of its own, and a SIGSTOPped broker still
  accepts TCP connects into its backlog, so only a round-trip proves it
  alive. `/readyz` polling covers the gateway the same way for HTTP.

Durability composes with the planes below: the broker's stream log replays
on restart, `bus/tcp.py` clients auto-reconnect + re-attach durable
consumers, unacked deliveries redeliver after ack_wait, and deterministic
point ids make redelivered work idempotent — so a SIGKILL anywhere in the
deployment (broker included) is a pause, not a loss. Proven end to end by
`python bench.py --only load_multiproc --multiproc` under a seeded kill
plan (bench/load.py) and the chaos scenarios in tests/test_procsup.py.

Metrics: `procsup.up{role}` (1 while the process runs), `procsup.restarts
{role}`, `procsup.heartbeat_age_s{role}`. Restart timestamps are kept on
each worker so a driver can measure kill→serving-again recovery
(`load_proc_recovery_s`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
import signal
import socket
import struct
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from symbiont_tpu_torch.utils.retry import jittered
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

OP_PING, OP_PONG = 4, 6  # symbus wire opcodes (protocol.hpp)


@dataclass
class WorkerSpec:
    """One supervised process: how to launch it and how to judge it."""

    role: str
    argv: List[str]
    env: Dict[str, str] = field(default_factory=dict)
    # process whose liveness rides bus heartbeats (RunnerConfig.heartbeat_s
    # must be set in env for these); 0 disables the hang detector
    heartbeat_timeout_s: float = 0.0
    # before the FIRST heartbeat ever arrives, judge against this longer
    # window instead: a worker importing torch and building its engine takes
    # far longer to start beating than a live one takes to stall
    boot_grace_s: float = 60.0
    # restart backoff
    backoff_base_s: float = 0.25
    backoff_max_s: float = 10.0
    # the broker worker: probed with a wire PING instead of heartbeats
    is_broker: bool = False
    probe_host: str = "127.0.0.1"
    probe_port: int = 0
    # elastic roles (scale_role): replicas of a base role are workers named
    # "<role>-<i>" carrying the base role here, so the autoscaler can count
    # and retire them as one fleet. Empty = this worker IS its base role.
    base_role: str = ""


class _Worker:
    def __init__(self, spec: WorkerSpec):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.started_at = 0.0
        self.last_heartbeat = 0.0   # monotonic ts of the last bus heartbeat
        self.up_events: List[float] = []  # heartbeat/probe confirmations
        self.task: Optional[asyncio.Task] = None
        self.stopping = False
        # drain protocol (scale-in): set by _drain_worker — an exit while
        # draining is retirement, never a restart; hang verdicts are
        # suppressed (a flushing worker legitimately stops beating last)
        self.draining = False
        self.drain_clean: Optional[bool] = None  # exited before the deadline?
        # what the worker itself reports in its heartbeat payload
        # (runner._heartbeat_payload: capacity 0 + draining true while the
        # drain protocol runs) — surfaced via procsup.draining / /api/fleet
        self.reported_draining = False
        self.reported_capacity = 1.0
        # restart-storm budget: timestamps of recent restarts; a worker
        # exceeding the storm bound parks in the `crashlooped` state
        # instead of burning CPU on an unbounded backoff loop
        self.restart_times: deque = deque()
        self.crashlooped = False


class ProcessSupervisor:
    """Launch, watch, and restart a set of worker processes.

    The supervisor owns its own bus client (connected lazily once the
    broker answers) purely for the heartbeat subscription — it never
    publishes application traffic.
    """

    def __init__(self, bus_url: str = "", heartbeat_poll_s: float = 0.25,
                 stdio=None, fleet_telemetry: bool = True,
                 fleet_publish_s: float = 2.0,
                 drain_deadline_s: float = 30.0,
                 storm_max_restarts: int = 8, storm_window_s: float = 60.0,
                 crashloop_cooloff_s: float = 300.0):
        self.bus_url = bus_url
        self.heartbeat_poll_s = heartbeat_poll_s
        self.workers: Dict[str, _Worker] = {}
        # drain enforcement (scale_role scale-in): a worker that has not
        # exited this long after the drain request is SIGKILLed — durable
        # redelivery makes even a hung drain lossless
        self.drain_deadline_s = drain_deadline_s
        # restart-storm budget: more than storm_max_restarts restarts
        # inside storm_window_s parks the worker in `crashlooped` (up=0,
        # procsup.crashlooped=1, no respawns) for crashloop_cooloff_s,
        # then allows ONE probe restart with a fresh budget — jittered
        # backoff alone caps at backoff_max_s and burns CPU forever on a
        # permanently-broken argv/env
        self.storm_max_restarts = storm_max_restarts
        self.storm_window_s = storm_window_s
        self.crashloop_cooloff_s = crashloop_cooloff_s
        # scale/drain audit trail consumed by the autoscaler's flap gate
        # and the ramp bench phase: (monotonic ts, base_role, "out"/"in",
        # replica name) appended by scale_role; drain_events records each
        # retirement's outcome as (ts, replica, clean, duration_s) —
        # clean=False means the deadline SIGKILL fired
        self.scale_events: List[tuple] = []
        self.drain_events: List[tuple] = []
        self._bus = None
        self._hb_task: Optional[asyncio.Task] = None
        self._mon_task: Optional[asyncio.Task] = None
        self._stopping = False
        # fleet telemetry plane (obs/fleet.py): the supervisor's own
        # `procsup.*` gauges live in a process with no HTTP server — an
        # exporter publishes them under role "procsup" so the API-role
        # aggregator federates them (the /api/fleet roll-up folds the
        # per-role up/restarts/hangs verdicts, broker probe included, into
        # each supervised role's entry); the supervisor also hosts its OWN
        # aggregator so `sup.fleet.rollup()` answers without any HTTP hop.
        self.fleet_telemetry = fleet_telemetry
        self.fleet_publish_s = fleet_publish_s
        self.fleet = None           # FleetAggregator once the bus is up
        self._fleet_exporter = None
        self._broker_healthy = True
        self._last_probe = 0.0
        # after the broker (re)covers, worker clients reconnect on THEIR
        # jittered exponential backoff (bus/tcp.py: up to several seconds)
        # — suppress hang verdicts for workers that have not yet beaten
        # since the recovery, for this long
        self.broker_resync_grace_s = 10.0
        self._resync_from = 0.0
        self._resync_until = 0.0
        # where worker stdio goes (default: inherit; tests pass DEVNULL or
        # an open log file)
        self._stdio = stdio

    # ------------------------------------------------------------ lifecycle

    def add_worker(self, spec: WorkerSpec) -> None:
        if spec.role in self.workers:
            raise ValueError(f"duplicate worker role {spec.role!r}")
        if not spec.base_role:
            spec = dataclasses.replace(spec, base_role=spec.role)
        self.workers[spec.role] = _Worker(spec)

    async def start(self) -> None:
        self._stopping = False
        loop = asyncio.get_running_loop()
        for w in self.workers.values():
            # executor: Popen's fork+exec is blocking host work (tens of ms
            # on a loaded box) and the supervisor's loop also runs the
            # 0.25s-period liveness probes — never stall them on a spawn
            await loop.run_in_executor(None, self._spawn, w)
            w.task = asyncio.create_task(self._monitor(w),
                                         name=f"procsup-{w.spec.role}")
        if self.bus_url:
            self._hb_task = asyncio.create_task(self._heartbeat_loop(),
                                                name="procsup-heartbeats")

    async def stop(self) -> None:
        self._stopping = True
        for w in self.workers.values():
            w.stopping = True
        if self._fleet_exporter is not None:
            await self._fleet_exporter.stop()
            self._fleet_exporter = None
        if self.fleet is not None:
            await self.fleet.detach()
            self.fleet = None
        if self._hb_task:
            self._hb_task.cancel()
            self._hb_task = None
        if self._bus is not None:
            try:
                await self._bus.close()
            except Exception:
                pass
            self._bus = None
        for w in self.workers.values():
            self._terminate(w, sig=signal.SIGTERM)
        for w in self.workers.values():
            if w.task is not None:
                w.task.cancel()
        tasks = [w.task for w in self.workers.values() if w.task]
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        # grace, then hard kill
        deadline = time.monotonic() + 5.0
        for w in self.workers.values():
            if w.proc is None:
                continue
            while w.proc.poll() is None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            if w.proc.poll() is None:
                self._terminate(w, sig=signal.SIGKILL)
                # executor: wait() blocks up to its timeout — the loop may
                # still be draining other workers' monitors
                await asyncio.get_running_loop().run_in_executor(
                    None, w.proc.wait, 5)
            metrics.gauge_set("procsup.up", 0,
                              labels={"role": w.spec.role})

    # -------------------------------------------------------------- spawn

    def _spawn(self, w: _Worker) -> None:
        # runs on an executor thread (start/_monitor) — which opens a
        # window where stop() flips the stopping flags while a restart is
        # already past its flag check. Re-check HERE (and once more after
        # the fork below): a supervisor that is stopping must never mint a
        # child it will not be watching.
        if self._stopping or w.stopping:
            return
        env = {**os.environ, **w.spec.env}
        kwargs = {}
        if self._stdio is not None:
            kwargs["stdout"] = self._stdio
            kwargs["stderr"] = self._stdio
        # own process group: a SIGKILL aimed at one worker must never leak
        # to the supervisor's group (and chaos plans kill by pid anyway)
        w.proc = subprocess.Popen(w.spec.argv, env=env,
                                  start_new_session=True, **kwargs)
        if self._stopping or w.stopping:
            # stop() ran while we were forking: its grace/kill loop may
            # already have polled the OLD proc and finished — this child
            # is ours to reap, fully (we are on an executor thread, so the
            # blocking waits are fine), and none of the started-state
            # below may run (the up gauge must stay 0 after stop()).
            self._terminate(w, sig=signal.SIGTERM)
            try:
                w.proc.wait(timeout=5)
            except Exception:
                self._terminate(w, sig=signal.SIGKILL)
                try:
                    w.proc.wait(timeout=5)
                except Exception:
                    pass
            return
        w.started_at = time.monotonic()
        w.last_heartbeat = 0.0
        if w.spec.is_broker:
            # a (re)started broker means every worker's client is about to
            # reconnect on ITS jittered backoff — heartbeats resume at
            # their pace, not ours. Open the resync grace window, or the
            # gap reads as a fleet-wide hang (a restart can also outrun the
            # 1s PING probe, so the broker-unhealthy gate alone is not
            # enough).
            self._note_broker_recovered()
        metrics.gauge_set("procsup.up", 1, labels={"role": w.spec.role})
        log.info("procsup: %s started (pid %d)", w.spec.role, w.proc.pid)

    def _note_broker_recovered(self) -> None:
        now = time.monotonic()
        self._resync_from = now
        self._resync_until = now + self.broker_resync_grace_s

    def _terminate(self, w: _Worker, sig=signal.SIGTERM) -> None:
        if w.proc is None or w.proc.poll() is not None:
            return
        try:
            w.proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass

    def pid(self, role: str) -> Optional[int]:
        w = self.workers[role]
        return None if w.proc is None else w.proc.pid

    def restarts(self, role: str) -> int:
        return self.workers[role].restarts

    # ------------------------------------------------------- elastic scaling

    def replicas(self, base_role: str) -> List[str]:
        """Replica worker names of one base role, base first, then by
        replica index — the retirement order is the reverse (newest
        drains first; the base replica never retires)."""
        names = [name for name, w in self.workers.items()
                 if w.spec.base_role == base_role]
        names.sort(key=lambda n: (n != base_role, len(n), n))
        return names

    def _replica_spec(self, base: WorkerSpec, index: int) -> WorkerSpec:
        """Spec for replica `index` (>= 2) of an elastic role: same argv,
        the role name (and SYMBIONT_RUNNER_ROLE, when the base is a
        runner) suffixed `-<index>` so heartbeats, fleet telemetry and
        the drain subject all address this replica individually, while
        the worker's queue-group subscriptions (named by SERVICE, not by
        role) share the durable streams with its siblings — fan-in is
        free."""
        name = f"{base.base_role or base.role}-{index}"
        env = dict(base.env)
        # always exported (harmless to non-runner workers): the replica
        # must identify as ITSELF on heartbeats and the drain subject
        env["SYMBIONT_RUNNER_ROLE"] = name
        return dataclasses.replace(base, role=name, env=env,
                                   base_role=base.base_role or base.role)

    async def scale_role(self, base_role: str, n: int) -> dict:
        """Resize an elastic role to `n` replicas (the autoscaler's one
        write surface). Scale-out spawns `<role>-<i>` workers joining the
        existing queue groups; scale-in retires the newest replicas
        through the drain protocol (`_drain_worker`): a `_sys.drain`
        request, a deadline, SIGKILL + durable redelivery as the safety
        net. n < 1 is rejected — the base replica always stays. Returns
        {"added": [...], "drained": [...]}."""
        base = self.workers.get(base_role)
        if base is None:
            raise ValueError(f"unknown role {base_role!r}")
        if n < 1:
            raise ValueError("scale_role target must be >= 1 "
                             "(the base replica never retires)")
        names = self.replicas(base_role)
        added: List[str] = []
        drained: List[str] = []
        loop = asyncio.get_running_loop()
        if n > len(names):
            # next replica indices resume past every name ever MINTED (the
            # scale_events audit trail remembers retired ones), so a dead
            # replica's role — whose final draining:true beat can still be
            # in flight — is never reused by a different process
            def _idx(nm: str):
                tail = nm.rsplit("-", 1)[-1]
                return int(tail) if nm != base_role and tail.isdigit() \
                    else None
            used = {i for i in map(_idx, names) if i is not None}
            used |= {i for i in (_idx(ev[3]) for ev in self.scale_events
                                 if ev[1] == base_role) if i is not None}
            idx = 2
            while len(names) + len(added) < n:
                while idx in used:
                    idx += 1
                spec = self._replica_spec(base.spec, idx)
                used.add(idx)
                self.add_worker(spec)
                w = self.workers[spec.role]
                await loop.run_in_executor(None, self._spawn, w)
                w.task = asyncio.create_task(
                    self._monitor(w), name=f"procsup-{w.spec.role}")
                added.append(spec.role)
                metrics.inc("procsup.scale_out",
                            labels={"role": base_role})
                log.info("procsup: scale-out %s -> %s", base_role,
                         spec.role)
                self.scale_events.append(
                    (time.monotonic(), base_role, "out", spec.role))
        elif n < len(names):
            for name in reversed(names[n:]):  # newest retires first
                metrics.inc("procsup.scale_in", labels={"role": base_role})
                self.scale_events.append(
                    (time.monotonic(), base_role, "in", name))
                await self._drain_worker(self.workers[name])
                drained.append(name)
        return {"added": added, "drained": drained}

    async def _drain_worker(self, w: _Worker,
                            deadline_s: Optional[float] = None) -> None:
        """Retire one worker through the drain protocol: publish
        `_sys.drain.<role>` (the worker detaches its durable consumers,
        flushes its coalescer, finishes in-flight work, beats
        `draining: true`, and exits rc 0), enforce the deadline, SIGKILL a
        hung drain (its unacked deliveries redeliver — still lossless),
        and remove the worker from supervision."""
        from symbiont_tpu_torch import subjects

        role = w.spec.role
        w.draining = True
        t_drain = time.monotonic()
        metrics.gauge_set("procsup.draining", 1, labels={"role": role})
        deadline_s = self.drain_deadline_s if deadline_s is None \
            else deadline_s
        sent = False
        if self._bus is not None:
            try:
                await self._bus.publish(f"{subjects.SYS_DRAIN}.{role}",
                                        b"{}")
                sent = True
            except Exception:
                log.warning("procsup: drain publish for %s failed", role)
        if not sent:
            # no bus (broker down, or a bus-less supervisor): SIGTERM is
            # the degraded drain — the runner's signal handler stops the
            # stack, whose service stops still flush-on-stop
            self._terminate(w, sig=signal.SIGTERM)
        loop = asyncio.get_running_loop()
        deadline = time.monotonic() + deadline_s
        # a publish to a subject nobody subscribes SUCCEEDS (C++ shells
        # have no drain subscription yet): if the worker neither exits nor
        # reports draining within a grace, escalate to SIGTERM so its
        # graceful-terminate path runs instead of burning the whole
        # deadline into a SIGKILL (common.hpp's promised fallback)
        term_at = time.monotonic() + min(5.0, deadline_s / 3.0) \
            if sent else None
        while time.monotonic() < deadline:
            if w.proc is None or w.proc.poll() is not None:
                break
            if (term_at is not None and not w.reported_draining
                    and time.monotonic() >= term_at):
                term_at = None
                log.info("procsup: %s never acknowledged the bus drain; "
                         "escalating to SIGTERM", role)
                self._terminate(w, sig=signal.SIGTERM)
            await asyncio.sleep(0.05)
        w.drain_clean = w.proc is None or w.proc.poll() is not None
        if not w.drain_clean:
            # the safety net: a hung drain still loses nothing — its
            # durable deliveries were never acked and redeliver to the
            # surviving replicas after ack_wait
            metrics.inc("procsup.drain_timeouts", labels={"role": role})
            log.warning("procsup: %s drain exceeded %.1fs; SIGKILL "
                        "(durable redelivery covers its in-flight work)",
                        role, deadline_s)
            self._terminate(w, sig=signal.SIGKILL)
            # durable redelivery only covers un-acked QUEUE work; a
            # mid-stream generation is past its ack — the journal is its
            # only recovery. Republish its tails to a surviving replica.
            await self._rescue_gen_orphans(w)
        w.stopping = True
        if w.task is not None:
            w.task.cancel()
            await asyncio.gather(w.task, return_exceptions=True)
            w.task = None
        if w.proc is not None:
            # reap off-loop; bounded — a zombie wait can't stall siblings
            try:
                await loop.run_in_executor(None, w.proc.wait, 10)
            except Exception:
                pass
        metrics.gauge_set("procsup.up", 0, labels={"role": role})
        metrics.gauge_set("procsup.draining", 0, labels={"role": role})
        log.info("procsup: %s drained (%s)", role,
                 "clean" if w.drain_clean else "deadline -> SIGKILL")
        self.drain_events.append((time.monotonic(), role, w.drain_clean,
                                  round(time.monotonic() - t_drain, 3)))
        self.workers.pop(role, None)

    # ------------------------------------------------ gen-session rescue

    async def _rescue_gen_orphans(self, w: _Worker) -> None:
        """Durable-generation recovery (docs/RESILIENCE.md): when a worker
        with the gen journal enabled dies mid-stream, scan its journal for
        live session tails, rotate the file aside, and republish each tail
        as a `tasks.generation.resume` task — the text-generator queue
        group picks exactly one surviving replica to adopt each stream.
        No-op for workers without SYMBIONT_GEN_JOURNAL_ENABLED in env.
        Requires the supervisor's bus: with the broker down, the file is
        left IN PLACE (unrotated) so a later death verdict — or the
        restarted role's own survivor reload — still covers it."""
        from symbiont_tpu_torch import subjects
        from symbiont_tpu_torch.config import GenJournalConfig
        from symbiont_tpu_torch.resilience.genlog import GenJournal

        env = w.spec.env
        if env.get("SYMBIONT_GEN_JOURNAL_ENABLED", "").lower() not in (
                "1", "true", "yes", "on"):
            return
        if self._bus is None:
            log.warning("procsup: %s died with a gen journal but the bus "
                        "is down; deferring the orphan scan", w.spec.role)
            return
        role = env.get("SYMBIONT_RUNNER_ROLE", w.spec.role)
        jdir = env.get("SYMBIONT_GEN_JOURNAL_DIR", GenJournalConfig().dir)
        path = os.path.join(jdir, f"{role}.genlog")
        # blocking file I/O (scan + rotate) off the supervisor loop — the
        # sibling monitors and the broker probe keep their 0.25s cadence
        try:
            tails = await asyncio.get_running_loop().run_in_executor(
                None, GenJournal.take_orphans, path)
        except Exception:
            log.warning("procsup: gen journal scan for %s failed",
                        w.spec.role, exc_info=True)
            return
        if not tails:
            return
        metrics.inc("gen.orphans", len(tails))
        log.warning("procsup: %s left %d orphaned generation session(s); "
                    "republishing for adoption", w.spec.role, len(tails))
        for task_id, rec in tails.items():
            body = json.dumps({"task_id": task_id, "record": rec,
                               "attempt": 0}).encode()
            try:
                await self._bus.publish(subjects.TASKS_GENERATION_RESUME,
                                        body)
            except Exception:
                log.warning("procsup: resume publish for %s failed",
                            task_id, exc_info=True)

    # ----------------------------------------------------------- liveness

    async def _monitor(self, w: _Worker) -> None:
        """Exit-code + hang supervision for one worker, with jittered
        exponential backoff between restarts (supervisor.py policy) and
        the restart-storm budget (crashloop parking)."""
        delay = w.spec.backoff_base_s
        while not self._stopping and not w.stopping:
            rc = w.proc.poll() if w.proc is not None else None
            if w.draining:
                # retirement in progress (_drain_worker owns the deadline
                # + SIGKILL): an exit now is the PROTOCOL, not a crash —
                # never restart, never judge hangs
                if rc is None:
                    await asyncio.sleep(self.heartbeat_poll_s)
                    continue
                metrics.gauge_set("procsup.up", 0,
                                  labels={"role": w.spec.role})
                return
            if rc == 0 and w.reported_draining:
                # a drain the supervisor did not initiate (operator-
                # published `_sys.drain.<role>`): the worker's last beat
                # announced the retirement and it exited clean — honoring
                # it beats respawning a process someone asked to go away.
                # REMOVED from supervision like a scale_role drain, so the
                # autoscaler/fleet stop counting a dead process as a live
                # serving replica
                log.info("procsup: %s retired after a self-reported drain",
                         w.spec.role)
                metrics.gauge_set("procsup.up", 0,
                                  labels={"role": w.spec.role})
                metrics.gauge_set("procsup.draining", 0,
                                  labels={"role": w.spec.role})
                self.drain_events.append(
                    (time.monotonic(), w.spec.role, True, 0.0))
                self.workers.pop(w.spec.role, None)
                return
            hung = self._is_hung(w)
            if rc is None and not hung:
                # healthy run resets the backoff after a stable period
                if time.monotonic() - w.started_at > 10 * delay:
                    delay = w.spec.backoff_base_s
                await asyncio.sleep(self.heartbeat_poll_s)
                continue
            if rc is None:
                # hung (heartbeats stalled / probe dead): only SIGKILL
                # clears a SIGSTOPped process
                log.warning("procsup: %s HUNG (no liveness signal for "
                            "%.1fs); killing pid %d", w.spec.role,
                            time.monotonic() - max(w.last_heartbeat,
                                                   w.started_at),
                            w.proc.pid)
                metrics.inc("procsup.hangs", labels={"role": w.spec.role})
                self._terminate(w, sig=signal.SIGKILL)
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, w.proc.wait, 10)
                except Exception:
                    pass
            else:
                log.warning("procsup: %s exited rc=%s", w.spec.role, rc)
            metrics.gauge_set("procsup.up", 0, labels={"role": w.spec.role})
            # the worker is CONFIRMED dead (exit or hang SIGKILL): rescue
            # any generation sessions its journal left mid-stream before
            # the restart — the restarted process must start from a fresh
            # journal, and a surviving replica adopts the streams
            await self._rescue_gen_orphans(w)
            if self._stopping or w.stopping:
                return
            if not await self._respect_storm_budget(w):
                return  # stop() interrupted the crashloop cool-off
            await asyncio.sleep(jittered(delay))
            delay = min(delay * 2, w.spec.backoff_max_s)
            if self._stopping or w.stopping:
                return
            w.restarts += 1
            w.restart_times.append(time.monotonic())
            metrics.inc("procsup.restarts", labels={"role": w.spec.role})
            # executor, like start(): a restart storm must not freeze the
            # sibling monitors and the broker probe behind serial forks
            await asyncio.get_running_loop().run_in_executor(
                None, self._spawn, w)

    async def _respect_storm_budget(self, w: _Worker) -> bool:
        """The restart-storm budget: a worker past `storm_max_restarts`
        restarts inside `storm_window_s` PARKS in the `crashlooped` state
        (up=0, `procsup.crashlooped{role}`=1, surfaced in /api/fleet) for
        `crashloop_cooloff_s` instead of burning CPU on fork/exec forever
        — jittered backoff alone is bounded per cycle, not per hour. After
        the cool-off, ONE probe restart runs with a fresh budget. Returns
        False when stop() interrupted the wait."""
        now = time.monotonic()
        while w.restart_times and now - w.restart_times[0] \
                > self.storm_window_s:
            w.restart_times.popleft()
        if len(w.restart_times) < self.storm_max_restarts:
            return True
        w.crashlooped = True
        metrics.gauge_set("procsup.crashlooped", 1,
                          labels={"role": w.spec.role})
        log.error("procsup: %s CRASHLOOPED (%d restarts in %.0fs); parked "
                  "for %.0fs", w.spec.role, len(w.restart_times),
                  self.storm_window_s, self.crashloop_cooloff_s)
        deadline = now + self.crashloop_cooloff_s
        while time.monotonic() < deadline:
            if self._stopping or w.stopping:
                return False
            await asyncio.sleep(min(0.5, self.heartbeat_poll_s * 2))
        w.crashlooped = False
        w.restart_times.clear()
        metrics.gauge_set("procsup.crashlooped", 0,
                          labels={"role": w.spec.role})
        log.warning("procsup: %s cool-off elapsed; probing one restart",
                    w.spec.role)
        return True

    def _is_hung(self, w: _Worker) -> bool:
        if w.spec.is_broker:
            return False  # judged by the probe loop (needs a round-trip)
        if w.draining:
            # a draining worker detaches its consumers and may stop
            # beating while it flushes: the DRAIN deadline (not the hang
            # detector) is its bound
            return False
        if w.spec.heartbeat_timeout_s <= 0:
            return False
        if not self._broker_healthy:
            # the broker is down/SIGSTOPped: NOBODY's heartbeats flow.
            # Judging workers now would turn one failure into many.
            return False
        if w.last_heartbeat == 0.0:
            # never beaten yet: still booting (torch import + engine build) —
            # judge against the boot grace, not the steady-state timeout
            return (time.monotonic() - w.started_at) > w.spec.boot_grace_s
        now = time.monotonic()
        if now < self._resync_until and w.last_heartbeat < self._resync_from:
            # broker just recovered and this worker hasn't beaten through
            # it yet: its client is mid-reconnect, not hung
            return False
        age = time.monotonic() - w.last_heartbeat
        metrics.gauge_set("procsup.heartbeat_age_s", round(age, 2),
                          labels={"role": w.spec.role})
        return age > w.spec.heartbeat_timeout_s

    async def _heartbeat_loop(self) -> None:
        """Subscribe `_sys.heartbeat.>` on the broker and stamp workers;
        also probes the broker itself (PING→PONG round-trip) and flips
        `_broker_healthy`, SIGKILLing a hung broker so its monitor
        restarts it over the persisted stream log."""
        from symbiont_tpu_torch import subjects
        from symbiont_tpu_torch.bus import connect

        sub = None
        while not self._stopping:
            # (re)connect the supervisor's own bus client
            if self._bus is None:
                try:
                    # retries=1: this loop IS the retry policy (fast poll)
                    self._bus = await connect(self.bus_url, retries=1)
                    sub = await self._bus.subscribe(
                        subjects.SYS_HEARTBEAT + ".>")
                    if self.fleet_telemetry:
                        await self._start_fleet_telemetry()
                except (ConnectionError, OSError):
                    self._bus = None
                    await asyncio.sleep(self.heartbeat_poll_s)
                    continue
            msg = await sub.next(self.heartbeat_poll_s)
            now = time.monotonic()
            if msg is not None:
                role = msg.subject.rsplit(".", 1)[-1]
                w = self.workers.get(role)
                if w is not None:
                    w.last_heartbeat = now
                    w.up_events.append(now)
                    del w.up_events[:-64]
                    self._note_heartbeat_payload(w, msg.data)
            await self._probe_broker()

    @staticmethod
    def _note_heartbeat_payload(w: _Worker, data: bytes) -> None:
        """Fold the beat's capacity/draining fields (runner
        `_heartbeat_payload`) into the worker's state: a worker reporting
        `draining: true` is mid-retirement — the roll-up shows it and the
        autoscaler stops counting it as serving headroom. Pre-field beats
        (C++ shells on an old image, the toy test workers' `{}`) read as
        serving at full capacity."""
        try:
            hb = json.loads(data) if data else {}
        except ValueError:
            hb = {}
        if not isinstance(hb, dict):
            return
        w.reported_draining = bool(hb.get("draining", False))
        try:
            w.reported_capacity = float(hb.get("capacity", 1))
        except (TypeError, ValueError):
            w.reported_capacity = 1.0
        metrics.gauge_set("procsup.draining",
                          1 if (w.reported_draining or w.draining) else 0,
                          labels={"role": w.spec.role})

    async def _start_fleet_telemetry(self) -> None:
        """Attach the supervisor's fleet aggregator to the (re)connected
        bus and start its own `procsup`-role exporter (once — the exporter
        reads the live bus through a closure, so reconnects are free)."""
        from symbiont_tpu_torch.obs.fleet import (
            FleetAggregator,
            TelemetryExporter,
            subscribe_telemetry,
        )

        if self.fleet is None:
            self.fleet = FleetAggregator(local_role="procsup")
        self.fleet.attach(await subscribe_telemetry(self._bus))
        if self._fleet_exporter is None:
            self._fleet_exporter = TelemetryExporter(
                lambda: self._bus, role="procsup",
                publish_s=self.fleet_publish_s)
            self._fleet_exporter.start()

    async def _probe_broker(self) -> None:
        """PING→PONG the broker over a fresh socket. A SIGSTOPped broker
        still ACCEPTS connections (kernel backlog) — only the round-trip
        proves the event loop is alive."""
        broker = next((w for w in self.workers.values()
                       if w.spec.is_broker), None)
        if broker is None:
            return
        now = time.monotonic()
        if now - self._last_probe < 1.0:
            return
        self._last_probe = now
        timeout = max(1.0, broker.spec.heartbeat_timeout_s or 3.0)
        ok = await asyncio.get_running_loop().run_in_executor(
            None, self._ping_once,
            broker.spec.probe_host, broker.spec.probe_port, timeout)
        if ok and not self._broker_healthy:
            # broker just came back (e.g. SIGCONT after a SIGSTOP — no
            # respawn involved): same resync grace as a restart
            self._note_broker_recovered()
        self._broker_healthy = ok
        metrics.gauge_set("procsup.up",
                          1 if (ok and broker.proc is not None
                                and broker.proc.poll() is None) else 0,
                          labels={"role": broker.spec.role})
        if ok:
            broker.last_heartbeat = now
            broker.up_events.append(now)
            del broker.up_events[:-64]
        elif (broker.proc is not None and broker.proc.poll() is None
              and broker.spec.heartbeat_timeout_s > 0
              and now - max(broker.last_heartbeat,
                            broker.started_at)
              > broker.spec.heartbeat_timeout_s):
            # alive by exit code, dead by probe: SIGSTOPped/deadlocked —
            # kill it; the monitor restarts it over the persisted log
            log.warning("procsup: broker %s unresponsive to PING; killing",
                        broker.spec.role)
            metrics.inc("procsup.hangs", labels={"role": broker.spec.role})
            self._terminate(broker, sig=signal.SIGKILL)

    @staticmethod
    def _ping_once(host: str, port: int, timeout_s: float) -> bool:
        try:
            with socket.create_connection((host, port),
                                          timeout=timeout_s) as s:
                s.settimeout(timeout_s)
                s.sendall(struct.pack("<IB", 1, OP_PING))
                head = b""
                while len(head) < 5:
                    chunk = s.recv(5 - len(head))
                    if not chunk:
                        return False
                    head += chunk
                n, op = struct.unpack("<IB", head)
                return op == OP_PONG
        except OSError:
            return False

    # ------------------------------------------------- recovery measurement

    async def wait_role_up(self, role: str, after: float,
                           timeout_s: float = 60.0) -> float:
        """Block until `role` shows a liveness confirmation (heartbeat or
        broker-probe success) AFTER monotonic time `after`; returns that
        confirmation's timestamp. The kill→serving-again measurement behind
        `load_proc_recovery_s`."""
        deadline = time.monotonic() + timeout_s
        w = self.workers[role]
        while time.monotonic() < deadline:
            for ts in w.up_events:
                if ts > after:
                    return ts
            await asyncio.sleep(0.05)
        raise TimeoutError(
            f"role {role!r} showed no liveness signal within {timeout_s}s "
            f"of the kill (restarts={w.restarts})")


# ----------------------------------------------------------------- helpers


def runner_spec(role: str, services: str, bus_url: str,
                env: Optional[Dict[str, str]] = None,
                heartbeat_s: float = 0.5,
                heartbeat_timeout_s: float = 5.0) -> WorkerSpec:
    """A WorkerSpec for one `python -m symbiont_tpu_torch.runner` role."""
    full_env = {
        "SYMBIONT_BUS_URL": bus_url,
        "SYMBIONT_RUNNER_SERVICES": services,
        "SYMBIONT_RUNNER_ROLE": role,
        "SYMBIONT_RUNNER_HEARTBEAT_S": str(heartbeat_s),
        **(env or {}),
    }
    return WorkerSpec(role=role,
                      argv=[sys.executable, "-m", "symbiont_tpu_torch.runner"],
                      env=full_env,
                      heartbeat_timeout_s=heartbeat_timeout_s)


def pybroker_spec(port: int, data_dir: str, role: str = "broker",
                  heartbeat_timeout_s: float = 5.0) -> WorkerSpec:
    """A WorkerSpec for the pure-Python broker (bus/pybroker.py)."""
    return WorkerSpec(
        role=role,
        argv=[sys.executable, "-m", "symbiont_tpu_torch.bus.pybroker",
              "--host", "127.0.0.1", "--port", str(port),
              "--data-dir", data_dir],
        is_broker=True, probe_port=port,
        heartbeat_timeout_s=heartbeat_timeout_s,
        # a fresh broker replays its log in well under a second; restart
        # fast so redelivery windows stay short
        backoff_base_s=0.2, backoff_max_s=2.0)
