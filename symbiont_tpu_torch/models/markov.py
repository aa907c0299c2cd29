"""Order-1 word-level Markov chain — behavioral parity with the reference's

Copy of the JAX package's `symbiont_tpu/models/markov.py`.
text generator (reference: services/text_generator_service/src/main.rs:13-109).

Semantics kept exactly:
- train: whitespace split; <2 words → record starter only (if any) and skip
  chain building; starters deduped; transitions are a multiset (duplicates
  weight the random walk) (reference: main.rs:29-80);
- generate: uniform-random starter, then up to max_length-1 uniform picks from
  the current word's successor list, stopping at a dead end; untrained model →
  the literal string "Model not trained." (reference: main.rs:82-108).

Beyond parity, `train` here accepts incremental corpus updates (the reference
retrains only on one hardcoded sentence at boot, main.rs:169-174, losing all
learned state each restart — SURVEY.md §5.4); our text_generator service feeds
it every ingested document and the state participates in checkpointing.
"""

from __future__ import annotations

import random
from typing import Dict, List


class MarkovModel:
    def __init__(self) -> None:
        self.chain: Dict[str, List[str]] = {}
        self.starters: List[str] = []

    def train(self, text: str) -> None:
        if not text:
            return
        words = text.split()
        if len(words) < 2:
            if words:
                self.starters.append(words[0])
                self._dedup_starters()
            return
        self.starters.append(words[0])
        for cur, nxt in zip(words, words[1:]):
            self.chain.setdefault(cur, []).append(nxt)
        self._dedup_starters()

    def _dedup_starters(self) -> None:
        # reference sorts + dedups after every train (main.rs:60-61)
        self.starters = sorted(set(self.starters))

    def generate(self, max_length: int, rng: random.Random | None = None) -> str:
        if not self.chain or not self.starters:
            return "Model not trained."
        rng = rng or random
        current = rng.choice(self.starters)
        out = [current]
        for _ in range(max_length - 1):
            nxt_words = self.chain.get(current)
            if not nxt_words:
                break
            current = rng.choice(nxt_words)
            out.append(current)
        return " ".join(out)

    # -- persistence (not in reference; supports checkpoint/resume §5.4) -----

    def to_state(self) -> dict:
        return {"chain": self.chain, "starters": self.starters}

    @classmethod
    def from_state(cls, state: dict) -> "MarkovModel":
        m = cls()
        m.chain = {k: list(v) for k, v in state["chain"].items()}
        m.starters = list(state["starters"])
        return m
