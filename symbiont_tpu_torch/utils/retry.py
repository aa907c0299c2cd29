"""Connect-retry shared by the external store adapters.

Copy of the JAX package's `symbiont_tpu/utils/retry.py`.

Mirrors the reference's connect-at-startup retry loops (Qdrant 5×5s:
reference vector_memory_service/src/main.rs:505-532; Neo4j 5×3s:
knowledge_graph_service/src/main.rs:253-284): warn per attempt, sleep only
BETWEEN attempts, raise ConnectionError with the last cause when exhausted.
Exceptions listed in `fatal` (config errors like a dim mismatch) propagate
immediately — retrying can't fix them.

Resilience-plane additions:
- `jitter`: full-jitter on the between-attempt sleep (uniform in
  [delay/2, delay]) so a fleet of workers restarting against one recovering
  backend doesn't reconnect in lockstep;
- `connect_retry_async`: the same loop with `asyncio.sleep`, for callers
  already on the event loop — the blocking variant smuggled `time.sleep`
  through executor threads, pinning a pool slot per retry window.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Awaitable, Callable, Optional, Tuple, Type, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")


def jittered(delay_s: float, rng: Optional[random.Random] = None) -> float:
    """Full-jitter backoff: uniform in [delay_s/2, delay_s] — concurrent
    retriers (handler retries, loop supervisors, TCP redials, store
    reconnects) must not stampede a recovering backend in lockstep. The
    ONE definition every backoff in the tree uses."""
    r = rng.random() if rng is not None else random.random()
    return delay_s * (0.5 + 0.5 * r)


def _sleep_for(delay_s: float, jitter: bool,
               rng: Optional[random.Random]) -> float:
    return jittered(delay_s, rng) if jitter else delay_s


def connect_retry(fn: Callable[[], T], *, retries: int, delay_s: float,
                  what: str,
                  fatal: Tuple[Type[BaseException], ...] = (),
                  jitter: bool = False,
                  rng: Optional[random.Random] = None) -> T:
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return fn()
        except fatal:
            raise
        except Exception as e:
            last = e
            log.warning("%s not ready (attempt %d/%d): %s",
                        what, attempt + 1, retries, e)
            if attempt + 1 < retries:
                time.sleep(_sleep_for(delay_s, jitter, rng))
    raise ConnectionError(f"{what} unreachable: {last}")


async def connect_retry_async(fn: Callable[[], Awaitable[T]], *,
                              retries: int, delay_s: float, what: str,
                              fatal: Tuple[Type[BaseException], ...] = (),
                              jitter: bool = False,
                              rng: Optional[random.Random] = None) -> T:
    """Async twin of connect_retry: `fn` is a coroutine factory; sleeps ride
    the event loop instead of blocking an executor thread."""
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return await fn()
        except fatal:
            raise
        except asyncio.CancelledError:
            raise
        except Exception as e:
            last = e
            log.warning("%s not ready (attempt %d/%d): %s",
                        what, attempt + 1, retries, e)
            if attempt + 1 < retries:
                await asyncio.sleep(_sleep_for(delay_s, jitter, rng))
    raise ConnectionError(f"{what} unreachable: {last}")
