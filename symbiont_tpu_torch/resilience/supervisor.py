"""Restart-with-backoff supervision for long-lived service loop tasks.

Copy of the JAX package's `symbiont_tpu/resilience/supervisor.py`.

The pre-resilience `Service._subscribe_loop` spawned its dispatch loop with
a bare `asyncio.create_task` and never looked at it again: an exception in
the loop body killed the consumer silently — the service kept reporting
healthy while eating no messages (the exact failure shape SURVEY.md §5.3
documents for the reference's spawned handlers). `supervise()` wraps such a
loop: a crash is logged with traceback, counted
(`service.loop_restarts{task=...}`), and the loop restarts after a jittered
exponential backoff. A clean return (subscription closed) or cancellation
(service stop) ends supervision.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Awaitable, Callable, Dict, Optional

from symbiont_tpu_torch.utils.retry import jittered
from symbiont_tpu_torch.utils.telemetry import metrics

log = logging.getLogger(__name__)

__all__ = ["supervise", "jittered"]


async def supervise(factory: Callable[[], Awaitable[None]], *, name: str,
                    backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                    labels: Optional[Dict[str, str]] = None,
                    still_wanted: Callable[[], bool] = lambda: True,
                    rng: Optional[random.Random] = None) -> None:
    """Run `await factory()` until it returns cleanly, restarting on
    exceptions with exponential backoff. `still_wanted` is consulted before
    each restart so a stopping service doesn't resurrect its loops."""
    delay = backoff_base_s
    while True:
        try:
            await factory()
            return  # clean exit: subscription closed / service stopping
        except asyncio.CancelledError:
            raise
        except Exception:
            if not still_wanted():
                return
            metrics.inc("service.loop_restarts",
                        labels={**(labels or {}), "task": name})
            log.exception("supervised task %r crashed; restarting in %.2fs",
                          name, delay)
            await asyncio.sleep(jittered(delay, rng))
            delay = min(delay * 2, backoff_max_s)
            if not still_wanted():
                return
