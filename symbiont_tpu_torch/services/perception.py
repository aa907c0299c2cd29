"""Perception service — web scraper.

Copy of the JAX package's `symbiont_tpu/services/perception.py`.

Parity with reference: services/perception_service/src/main.rs.
Consumes PerceiveUrlTask from tasks.perceive.url (queue-grouped here),
fetches with a 15s timeout + custom UA (main.rs:89-94), extracts main content
via the selector cascade (html_extract.py), publishes RawTextMessage to
data.raw_text.discovered (main.rs:67-69). Empty extractions are dropped with
a warning, matching scrape_and_publish (main.rs:15-84).
"""

from __future__ import annotations

import asyncio
import logging
import urllib.request
from typing import Optional

from symbiont_tpu_torch import subjects
from symbiont_tpu_torch.bus.core import Msg
from symbiont_tpu_torch.config import PerceptionConfig
from symbiont_tpu_torch.schema import PerceiveUrlTask, RawTextMessage, from_json, to_json_bytes
from symbiont_tpu_torch.services.base import Service
from symbiont_tpu_torch.services.html_extract import extract_main_text
from symbiont_tpu_torch.utils.ids import current_timestamp_ms, generate_uuid
from symbiont_tpu_torch.utils.telemetry import child_headers, metrics

log = logging.getLogger(__name__)


class PerceptionService(Service):
    name = "perception"

    def __init__(self, bus, config: Optional[PerceptionConfig] = None,
                 fetcher=None):
        super().__init__(bus)
        self.config = config or PerceptionConfig()
        # fetcher injectable for tests (the seam the reference has but never
        # uses, SURVEY.md §4)
        self._fetch = fetcher or self._http_fetch

    async def _setup(self) -> None:
        await self._subscribe_loop(subjects.TASKS_PERCEIVE_URL,
                                   self._handle_task,
                                   queue=subjects.QUEUE_PERCEPTION)

    def _http_fetch(self, url: str) -> str:
        req = urllib.request.Request(
            url, headers={"User-Agent": self.config.user_agent})
        with urllib.request.urlopen(req, timeout=self.config.scrape_timeout_s) as r:
            charset = r.headers.get_content_charset() or "utf-8"
            return r.read().decode(charset, errors="replace")

    async def _handle_task(self, msg: Msg) -> None:
        task = from_json(PerceiveUrlTask, msg.data)
        try:
            html = await asyncio.get_running_loop().run_in_executor(
                None, self._fetch, task.url)
        except Exception as e:
            metrics.inc("perception.scrape_failed")
            log.warning("scrape failed for %s: %s", task.url, e)
            return
        text = extract_main_text(html)
        if not text:
            metrics.inc("perception.empty_extraction")
            log.warning("no meaningful text extracted from %s", task.url)
            return
        out = RawTextMessage(id=generate_uuid(), source_url=task.url,
                             raw_text=text, timestamp_ms=current_timestamp_ms())
        await self.bus.publish(subjects.DATA_RAW_TEXT_DISCOVERED,
                               to_json_bytes(out),
                               headers=child_headers(msg.headers))
        metrics.inc("perception.published")
