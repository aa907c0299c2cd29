"""The engine's flight recorder: a bounded ring of decode and embed events.

The port's copy of `symbiont_tpu/obs/engine_timeline.py`, recorded from
host values already in hand (no new device syncs):

- decode half: `LmEngine`'s `BatchSession` notes one `step` event per
  decode chunk or speculative round (wall ms, live rows against the batch
  bucket, engine-wide KV rows live against allocated, host gap since the
  last chunk; paged engines add the pool's pages free, live and total,
  spec rounds their draft and verify ms and draft tokens proposed and
  accepted), an `admit` per session start or splice (rows, prefill ms, the
  share of the new prompts' token prefix that recent prompts already had;
  paged engines add the prompt tokens served from radix-shared pages), a
  `finish` per request (tokens, engine-side TTFT; paged engines add
  whether its whole prompt was a radix hit) and a `cancel` per aborted
  one, and a `resume` per orphaned stream adopted from a dead worker's
  journal (tokens it had generated, the re-prefill's ms, the prefix tokens
  still radix-resident here); the generation batcher notes its queue depth
  (`queue`); at a chunk
  boundary, at most every `_MEM_SAMPLE_S` seconds, the device-memory
  ledger's claims land as one `mem` event;
- embed half: `TorchEngine._note_padding` notes one `flush` per embed or
  rerank batch, and the windowed `engine.packing_opportunity_pct` is the
  share of dispatched token slots that carried padding.

`summary` gives the JAX summary's fields, its paged view (radix hit share,
hit and cold TTFT, live pages) and spec view (rounds, acceptance, draft and
verify ms) appearing only when such events exist, so dense, spec-off
recorders read as before. `configure` sizes the ring and the prompt window
at boot (a capacity of 0 turns the recorder off); the gateway renders the
Perfetto export (`obs/chrome_trace.py`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

from symbiont_tpu_torch.utils.telemetry import Metrics, metrics as _global_metrics

STEP, ADMIT, FINISH, CANCEL, QUEUE, FLUSH, RESUME, MEM = (
    "step", "admit", "finish", "cancel", "queue", "flush", "resume", "mem")

# prompt tokens kept per entry of the prefix probe: overlap past this depth
# counts as full depth, which bounds the cost of one admit
_PREFIX_DEPTH = 128

# recent admitted prompts the prefix probe compares a new one against
_PROMPT_WINDOW = 64

# least seconds between two device-memory samples on the decode path
_MEM_SAMPLE_S = 0.5


class EngineTimeline:
    """Thread-safe bounded ring of engine events with windowed probes.
    `note_*` calls take the lock, append one dict and return; statistics
    are computed when read."""

    def __init__(self, capacity: int = 2048, registry: Optional[Metrics] = None):
        self.registry = registry if registry is not None else _global_metrics
        self._lock = threading.Lock()
        self._enabled = int(capacity) > 0
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        # prefix probe: recent prompts' token prefixes (bounded depth)
        self._prompts: deque = deque(maxlen=_PROMPT_WINDOW)
        self._shares: deque = deque(maxlen=256)  # lm.prefix_share_ratio window
        # packing-opportunity window over recent embed flushes
        self._flushes: deque = deque(maxlen=128)
        self._flush_real = 0
        self._flush_total = 0
        self._last_mem_t = 0.0  # last device-memory sample (monotonic)

    def configure(self, capacity: int, prompt_window: int) -> None:
        """Apply ObsConfig sizing (runner, at boot), keeping the newest
        events; a capacity of 0 turns the recorder off."""
        with self._lock:
            self._enabled = int(capacity) > 0
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))
            self._prompts = deque(self._prompts, maxlen=max(1, int(prompt_window)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._prompts.clear()
            self._shares.clear()
            self._flushes.clear()
            self._flush_real = 0
            self._flush_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def _append(self, ev: dict) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._ring.append(ev)

    # ------------------------------------------------------------ recording

    def note_decode_step(self, wall_ms: float, rows_live: int, rows_capacity: int,
                         kv_rows_live: int, kv_rows_allocated: int, steps: float,
                         sessions: int = 1, pages_free: Optional[int] = None,
                         pages_live: Optional[int] = None, pages_total: Optional[int] = None,
                         dispatches: Optional[int] = None,
                         host_gap_ms: Optional[float] = None,
                         spec_draft_ms: Optional[float] = None,
                         spec_verify_ms: Optional[float] = None,
                         spec_proposed: Optional[int] = None,
                         spec_accepted: Optional[int] = None) -> None:
        """One decode chunk or spec round. `dispatches` and `host_gap_ms`
        are its dispatch count and the host time between the previous
        chunk's device work and this one's; `pages_*` the pool's occupancy
        (paged engines); `spec_*` a round's draft/verify wall split and its
        proposed/accepted draft tokens, where `steps` is the mean tokens a
        live row emitted (fractional)."""
        ev = {"kind": STEP, "t": time.time(), "wall_ms": wall_ms,
              "rows_live": int(rows_live), "rows_capacity": int(rows_capacity),
              "kv_rows_live": int(kv_rows_live),
              "kv_rows_allocated": int(kv_rows_allocated),
              "steps": int(steps), "sessions": int(sessions)}
        if pages_total is not None:
            ev.update(pages_free=int(pages_free or 0), pages_live=int(pages_live or 0),
                      pages_total=int(pages_total))
        if host_gap_ms is not None:
            ev["dispatches"] = int(dispatches or 0)
            ev["host_gap_ms"] = float(host_gap_ms)
        if spec_proposed is not None:
            ev.update(steps=float(steps), spec_draft_ms=float(spec_draft_ms or 0.0),
                      spec_verify_ms=float(spec_verify_ms or 0.0),
                      spec_proposed=int(spec_proposed), spec_accepted=int(spec_accepted or 0))
        self._append(ev)
        self._maybe_note_memory()

    def _maybe_note_memory(self) -> None:
        """Sample the device-memory ledger's claims into the ring, at most
        every _MEM_SAMPLE_S seconds."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_mem_t < _MEM_SAMPLE_S:
                return
            self._last_mem_t = now
        from symbiont_tpu_torch.obs.hbm import hbm_ledger

        rows = hbm_ledger.rows()
        if not rows:
            return
        ev = {"kind": MEM, "t": time.time()}
        for r in rows:
            if not r["overlay"]:
                ev[r["subsystem"]] = r["bytes"]
        self._append(ev)

    def note_admit(self, rows: int, prefill_ms: float,
                   prefix_share: Optional[float] = None, kind: str = "start",
                   hit_tokens: Optional[int] = None,
                   prompt_tokens: Optional[int] = None) -> None:
        """A prefill joined the decode plane: a session start or a splice.
        `hit_tokens`/`prompt_tokens` (paged engines): the prompt tokens
        served from radix-shared pages, of all its prompt tokens."""
        ev = {"kind": ADMIT, "t": time.time(), "rows": int(rows),
              "prefill_ms": prefill_ms, "admit_kind": kind}
        if prefix_share is not None:
            ev["prefix_share"] = prefix_share
        if prompt_tokens is not None:
            ev["hit_tokens"] = int(hit_tokens or 0)
            ev["prompt_tokens"] = int(prompt_tokens)
        self._append(ev)

    def note_finish(self, tokens: int, ttft_ms: Optional[float] = None,
                    radix_hit: Optional[bool] = None) -> None:
        """`radix_hit` (paged engines): the request's whole prompt came from
        the radix cache and its prefill was skipped."""
        ev = {"kind": FINISH, "t": time.time(), "tokens": int(tokens)}
        if ttft_ms is not None:
            ev["ttft_ms"] = ttft_ms
        if radix_hit is not None:
            ev["radix_hit"] = bool(radix_hit)
        self._append(ev)

    def note_cancel(self) -> None:
        self._append({"kind": CANCEL, "t": time.time()})

    def note_resume(self, tokens: int, prefill_ms: float,
                    warm_tokens: Optional[int] = None) -> None:
        """One orphaned generation stream adopted on this engine (a
        journal tail, resilience/genlog.py): `tokens` the dead worker had
        generated, `prefill_ms` of re-prefilling prompt + generated prefix,
        `warm_tokens` of that prefix still radix-resident here (kv/radix.py
        `peek`). Counts `gen.resumes` (and `gen.resume_warm_tokens`), the
        adopting side of the supervisor's `gen.orphans`."""
        self.registry.inc("gen.resumes")
        if warm_tokens:
            self.registry.inc("gen.resume_warm_tokens", int(warm_tokens))
        ev = {"kind": RESUME, "t": time.time(),
              "tokens": int(tokens), "prefill_ms": float(prefill_ms)}
        if warm_tokens is not None:
            ev["warm_tokens"] = int(warm_tokens)
        self._append(ev)

    def note_queue_depth(self, queue: str, depth: int) -> None:
        self._append({"kind": QUEUE, "t": time.time(), "queue": str(queue),
                      "depth": int(depth)})

    def note_embed_flush(self, bucket: int, batch_rows: int, n_real: int,
                         real_tokens: int, total_tokens: int) -> None:
        """One dispatched embed/rerank batch; also moves the windowed
        packing-opportunity estimate."""
        if not self._enabled:
            return
        with self._lock:
            self._ring.append({"kind": FLUSH, "t": time.time(), "bucket": int(bucket),
                               "batch_rows": int(batch_rows), "n_real": int(n_real),
                               "real_tokens": int(real_tokens),
                               "total_tokens": int(total_tokens)})
            if len(self._flushes) == self._flushes.maxlen:
                old_real, old_total = self._flushes[0]
                self._flush_real -= old_real
                self._flush_total -= old_total
            self._flushes.append((int(real_tokens), int(total_tokens)))
            self._flush_real += int(real_tokens)
            self._flush_total += int(total_tokens)
            total, real = self._flush_total, self._flush_real
        if total > 0:  # the registry has its own lock
            self.registry.gauge_set("engine.packing_opportunity_pct",
                                    round(100.0 * (1.0 - real / total), 2),
                                    labels={"service": "engine"})

    # --------------------------------------------------------- prefix probe

    def prompt_prefix_share(self, token_rows: Sequence[Sequence[int]]) -> float:
        """For each new prompt, the longest common token prefix with any
        recently admitted prompt, as a share of its (depth-bounded) length.
        Returns the mean over the rows and moves the windowed
        `lm.prefix_share_ratio` gauge. Host arithmetic on encoded ids."""
        if not self._enabled or not token_rows:
            return 0.0
        shares = []
        with self._lock:
            registry = list(self._prompts)
            for row in token_rows:
                head = tuple(row[:_PREFIX_DEPTH])
                if not head:
                    continue
                best = 0
                for prev in registry:
                    if best >= len(head):
                        break
                    n = 0
                    for a, b in zip(head, prev):
                        if a != b:
                            break
                        n += 1
                    best = max(best, n)
                shares.append(best / len(head))
                self._prompts.append(head)
                registry.append(head)
            if not shares:
                return 0.0
            self._shares.extend(shares)
            window = list(self._shares)
        self.registry.gauge_set("lm.prefix_share_ratio", round(sum(window) / len(window), 4),
                                labels={"service": "lm"})
        return sum(shares) / len(shares)

    # -------------------------------------------------------------- summary

    def summary(self) -> dict:
        """Aggregates over the ring: a recent picture, not a lifetime
        average."""
        events = self.events()
        steps = [e for e in events if e["kind"] == STEP]
        admits = [e for e in events if e["kind"] == ADMIT]
        finishes = [e for e in events if e["kind"] == FINISH]
        cancels = [e for e in events if e["kind"] == CANCEL]
        flushes = [e for e in events if e["kind"] == FLUSH]

        def pct(num: float, den: float) -> float:
            return round(100.0 * num / den, 2) if den else 0.0

        def quantile(vals: List[float], q: float) -> float:
            if not vals:
                return 0.0
            vals = sorted(vals)
            return round(vals[min(len(vals) - 1, int(q * len(vals)))], 2)

        step_ms = [e["wall_ms"] for e in steps]
        ttfts = [e["ttft_ms"] for e in finishes if "ttft_ms" in e]
        shares = [e["prefix_share"] for e in admits if "prefix_share" in e]
        real_tok = sum(e["real_tokens"] for e in flushes)
        total_tok = sum(e["total_tokens"] for e in flushes)
        out = {
            "decode_steps": len(steps),
            "decode_occupancy_pct": pct(sum(e["rows_live"] for e in steps),
                                        sum(e["rows_capacity"] for e in steps)),
            "decode_kv_stranded_pct": pct(
                sum(e["kv_rows_allocated"] - e["kv_rows_live"] for e in steps),
                sum(e["kv_rows_allocated"] for e in steps)),
            "decode_prefix_share_pct": (round(100.0 * sum(shares) / len(shares), 2)
                                        if shares else 0.0),
            "decode_admits": len(admits),
            "decode_finishes": len(finishes),
            "decode_cancels": len(cancels),
            "decode_prefill_ms_total": round(sum(e["prefill_ms"] for e in admits), 2),
            "decode_step_ms_total": round(sum(step_ms), 2),
            "decode_step_ms_p50": quantile(step_ms, 0.50),
            "decode_tpot_ms_p50": quantile([e["wall_ms"] / e["steps"] for e in steps
                                            if e["steps"]], 0.50),
            "decode_ttft_ms_p50": quantile(ttfts, 0.50),
            "decode_ttft_ms_p99": quantile(ttfts, 0.99),
            "embed_flushes": len(flushes),
            "embed_padding_pct": pct(total_tok - real_tok, total_tok),
            "packing_opportunity_pct": pct(total_tok - real_tok, total_tok),
        }
        # the paged view: radix hits from the admits' token counts, hit and
        # cold TTFT, the pool's occupancy from the step snapshots
        paged_steps = [e for e in steps if "pages_total" in e]
        paged_admits = [e for e in admits if "prompt_tokens" in e]
        if paged_steps or paged_admits:
            out["decode_radix_hit_pct"] = pct(sum(e["hit_tokens"] for e in paged_admits),
                                              sum(e["prompt_tokens"] for e in paged_admits))
            out["decode_ttft_hit_ms_p50"] = quantile(
                [e["ttft_ms"] for e in finishes if "ttft_ms" in e and e.get("radix_hit")], 0.50)
            out["decode_ttft_cold_ms_p50"] = quantile(
                [e["ttft_ms"] for e in finishes
                 if "ttft_ms" in e and e.get("radix_hit") is False], 0.50)
        if paged_steps:
            out["decode_pages_live_pct"] = pct(sum(e["pages_live"] for e in paged_steps),
                                               sum(e["pages_total"] for e in paged_steps))
        gap_steps = [e for e in steps if "host_gap_ms" in e]
        if gap_steps:
            gen_tokens = sum(e["steps"] for e in gap_steps)
            gap_ms = sum(e["host_gap_ms"] for e in gap_steps)
            busy_ms = sum(e["wall_ms"] for e in gap_steps)
            out["decode_dispatches_per_token"] = (
                round(sum(e["dispatches"] for e in gap_steps) / gen_tokens, 4)
                if gen_tokens else 0.0)
            out["decode_host_gap_pct"] = pct(gap_ms, gap_ms + busy_ms)
        # the spec view: only rounds of a spec-enabled engine carry spec_*
        spec_steps = [e for e in steps if "spec_proposed" in e]
        if spec_steps:
            out["decode_spec_rounds"] = len(spec_steps)
            out["decode_spec_accept_pct"] = pct(sum(e["spec_accepted"] for e in spec_steps),
                                                sum(e["spec_proposed"] for e in spec_steps))
            out["decode_spec_draft_ms_total"] = round(
                sum(e["spec_draft_ms"] for e in spec_steps), 2)
            out["decode_spec_verify_ms_total"] = round(
                sum(e["spec_verify_ms"] for e in spec_steps), 2)
        out["dominant_stall"] = self._dominant_stall(out)
        return out

    @staticmethod
    def _dominant_stall(s: dict) -> str:
        """Which measured waste dominates the window: each candidate is a
        share of provisioned work not doing useful decode or prefill."""
        if not s["decode_steps"] and not s["embed_flushes"]:
            return "no engine traffic recorded"
        candidates = []
        if s["decode_steps"]:
            candidates.append((f"row underfill (batch occupancy {s['decode_occupancy_pct']}%)",
                               100.0 - s["decode_occupancy_pct"]))
            candidates.append((f"stranded KV rows ({s['decode_kv_stranded_pct']}% of "
                               "allocated slabs)", s["decode_kv_stranded_pct"]))
            total = s["decode_prefill_ms_total"] + s["decode_step_ms_total"]
            if total > 0:
                prefill_pct = round(100.0 * s["decode_prefill_ms_total"] / total, 2)
                candidates.append((f"admission prefills ({prefill_pct}% of engine wall)",
                                   prefill_pct))
            if "decode_radix_hit_pct" in s:
                # prefix overlap the radix cache did not turn into shared
                # pages: cold prefills of what other sessions already paid for
                cold = max(0.0, s["decode_prefix_share_pct"] - s["decode_radix_hit_pct"])
                candidates.append((f"cold prefix prefills (prefix share "
                                   f"{s['decode_prefix_share_pct']}% vs radix hits "
                                   f"{s['decode_radix_hit_pct']}%)", round(cold, 2)))
            if "decode_host_gap_pct" in s:
                candidates.append((f"host-dispatch gap ({s['decode_host_gap_pct']}% of chunk "
                                   f"wall host-side, {s['decode_dispatches_per_token']} "
                                   "dispatches/token)", s["decode_host_gap_pct"]))
        if s["embed_flushes"]:
            candidates.append((f"embed padding (packing opportunity "
                               f"{s['packing_opportunity_pct']}%)",
                               s["packing_opportunity_pct"]))
        label, worst = max(candidates, key=lambda c: c[1])
        if worst < 10.0:
            return "none dominant (all measured waste < 10%)"
        return label


# the process-global recorder
engine_timeline = EngineTimeline()
