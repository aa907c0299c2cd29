"""Deterministic fault-injection harness for the chaos suite.

Copy of the JAX package's `symbiont_tpu/resilience/faults.py`.

A `FaultPlan` is a seeded list of `FaultRule`s consulted at fixed seams in
the framework (bus publish/deliver, handler invocation, store calls, TCP
sends). Production cost is one module-attribute read per seam: with no plan
active every seam check is `if _ACTIVE is None: return None`.

Determinism contract: given the same seed, the same rules, and the same
sequence of seam operations, a plan fires the same faults at the same
operations — chaos tests assert exact loss/recovery counts, so nothing here
reads the wall clock or an unseeded RNG.

Seams (the `seam` a rule names → where it is consulted):
- "bus.publish"   InprocBus.publish (kinds: drop, delay, error)
- "bus.deliver"   inproc durable pump, per delivery attempt (drop, delay)
- "handler"       Service._run_handler, inside the timeout window
                  (error, hang, delay); key is "<service>:<subject>"
- "store.upsert"  ResilientVectorStore.upsert (error, reset)
- "store.search"  ResilientVectorStore.search (error, reset)
- "graph.save"    ResilientGraphStore.save_tokenized (error, reset)
- "tcp.send"      TcpBus._send_frame (reset)
"""

from __future__ import annotations

import asyncio
import fnmatch
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class FaultInjected(RuntimeError):
    """The exception raised by kind="error" rules (and the marker chaos
    tests catch to tell injected failures from real bugs)."""


@dataclass
class FaultRule:
    """One injectable fault. Matching is positional and deterministic:
    each rule keeps its own count of matching operations; it fires on
    operations `after <= i < after + times` (by that count), gated by
    `prob` drawn from the plan's seeded RNG."""

    seam: str
    kind: str  # "error" | "drop" | "delay" | "hang" | "reset"
    match: str = "*"  # fnmatch pattern over the seam's op key
    times: int = 1  # max fires; 0 = unlimited
    after: int = 0  # skip the first `after` matching operations
    delay_s: float = 0.0  # for delay/hang kinds
    prob: float = 1.0  # fire probability per eligible operation
    message: str = ""  # error text override

    _KINDS = ("error", "drop", "delay", "hang", "reset")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"fault kind must be one of {self._KINDS}, "
                             f"got {self.kind!r}")


@dataclass
class _RuleState:
    matched: int = 0
    fired: int = 0


class FaultPlan:
    """Seeded, inspectable fault schedule. Use as:

        plan = FaultPlan(seed=7, rules=[
            FaultRule(seam="handler", kind="error",
                      match="vector_memory:*", times=2)])
        with plan.activate():
            ... run the stack ...
        assert plan.fired[("handler", "error")] == 2
    """

    def __init__(self, seed: int = 0, rules: Optional[List[FaultRule]] = None):
        self.seed = seed
        self.rules = list(rules or [])
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._state: Dict[int, _RuleState] = {
            i: _RuleState() for i in range(len(self.rules))}
        # (seam, kind) -> fire count; test introspection surface
        self.fired: Dict[Tuple[str, str], int] = {}
        # every fired (seam, kind, key) in order; deterministic transcript
        self.log: List[Tuple[str, str, str]] = []

    def add(self, rule: FaultRule) -> "FaultPlan":
        with self._lock:
            self._state[len(self.rules)] = _RuleState()
            self.rules.append(rule)
        return self

    # ------------------------------------------------------------- matching

    def check(self, seam: str, key: str) -> Optional[FaultRule]:
        """Return the rule firing for this operation, or None. Counts the
        operation against every rule of the seam whose pattern matches
        (each rule sees its own op index), first firing rule wins."""
        with self._lock:
            hit: Optional[FaultRule] = None
            for i, rule in enumerate(self.rules):
                if rule.seam != seam or not fnmatch.fnmatch(key, rule.match):
                    continue
                st = self._state[i]
                idx = st.matched
                st.matched += 1
                if hit is not None:
                    continue  # already firing this op; keep counting others
                if idx < rule.after:
                    continue
                if rule.times and st.fired >= rule.times:
                    continue
                if rule.prob < 1.0 and self.rng.random() >= rule.prob:
                    continue
                st.fired += 1
                k = (seam, rule.kind)
                self.fired[k] = self.fired.get(k, 0) + 1
                self.log.append((seam, rule.kind, key))
                hit = rule
            return hit

    # ------------------------------------------------------------- applying

    def _raise(self, rule: FaultRule, seam: str, key: str) -> None:
        msg = rule.message or f"injected {rule.kind} at {seam} ({key})"
        if rule.kind == "reset":
            raise ConnectionResetError(msg)
        raise FaultInjected(msg)

    def sync_fault(self, seam: str, key: str) -> Optional[FaultRule]:
        """Blocking-context seam (store calls run in executor threads).
        Raises for error/reset, sleeps for delay/hang, returns the rule for
        drop (caller decides what dropping means at its seam)."""
        rule = self.check(seam, key)
        if rule is None:
            return None
        if rule.kind in ("delay", "hang"):
            time.sleep(rule.delay_s)
            return rule
        if rule.kind == "drop":
            return rule
        self._raise(rule, seam, key)
        return rule  # unreachable

    async def async_fault(self, seam: str, key: str) -> Optional[FaultRule]:
        """Event-loop seam. Same contract as sync_fault with awaitable
        sleeps — a "hang" inside a handler is an `await asyncio.sleep`
        the handler-timeout cancellation can actually cancel."""
        rule = self.check(seam, key)
        if rule is None:
            return None
        if rule.kind in ("delay", "hang"):
            await asyncio.sleep(rule.delay_s)
            return rule
        if rule.kind == "drop":
            return rule
        self._raise(rule, seam, key)
        return rule  # unreachable

    # ------------------------------------------------------------ lifecycle

    @contextmanager
    def activate(self):
        """Install this plan as the process-active one for the duration.
        Nestable (the previous plan is restored); chaos tests wrap each
        scenario so no fault leaks across tests."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    """The seams' entry point — None (the fast path) unless a chaos test
    has a plan activated."""
    return _ACTIVE
