"""Subword tokenization for the engine (host-side).

A copy of `symbiont_tpu/engine/tokenizer.py`: the port imports nothing of
the JAX package, so it keeps its own copy of this numpy/stdlib module.

The reference tokenizes with HF `tokenizers` configured for fixed padding to
model max + LongestFirst truncation (reference:
services/preprocessing_service/src/embedding_generator.rs:75-99). Here
truncation stays (to model max) but padding moves to the bucketing layer
(engine/bucketing.py) — the whole point of §5.7's redesign.

Two implementations:
- HFTokenizer: loads a tokenizer.json from a local model dir (the format every
  model in BASELINE.md ships). Offline only — no hub download.
- HashTokenizer: deterministic, file-free tokenizer (regex word split + stable
  hash into the vocab). Used by tests and benchmarks so the full pipeline runs
  with zero model assets; NOT semantically meaningful.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import List, Protocol, Sequence, Tuple


class Tokenizer(Protocol):
    cls_id: int
    sep_id: int
    pad_id: int

    def encode(self, text: str, max_len: int) -> List[int]:
        """Token ids incl. special tokens, truncated to max_len."""
        ...

    def encode_batch(self, texts: Sequence[str], max_len: int) -> List[List[int]]:
        """Batch encode — HF tokenizers parallelizes this in native code."""
        ...

    def encode_pair(self, a: str, b: str, max_len: int) -> Tuple[List[int], List[int]]:
        """(ids, token_type_ids) for cross-encoder input, truncated to max_len."""
        ...


class HFTokenizer:
    def __init__(self, tokenizer_file: str | Path):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(str(tokenizer_file))
        self._tok.no_padding()
        self._tok.no_truncation()

        def _tid(*names: str) -> int:
            for n in names:
                i = self._tok.token_to_id(n)
                if i is not None:
                    return i
            return 0  # reference falls back to id 0 for [PAD]
                      # (embedding_generator.rs:86-90)

        self.cls_id = _tid("[CLS]", "<s>")
        self.sep_id = _tid("[SEP]", "</s>")
        self.pad_id = _tid("[PAD]", "<pad>")

    def _truncate(self, ids: List[int], max_len: int) -> List[int]:
        # LongestFirst truncation parity: keep specials, trim the middle
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
        return ids

    def encode(self, text: str, max_len: int) -> List[int]:
        return self._truncate(self._tok.encode(text).ids, max_len)

    def encode_batch(self, texts: Sequence[str], max_len: int) -> List[List[int]]:
        """One call into the native tokenizer — it parallelizes across texts
        (rayon), vs the serial per-text path the reference uses for whole
        documents (embedding_generator.rs:160-164)."""
        encs = self._tok.encode_batch(list(texts))
        return [self._truncate(e.ids, max_len) for e in encs]

    def encode_pair(self, a: str, b: str, max_len: int) -> Tuple[List[int], List[int]]:
        enc = self._tok.encode(a, b)
        ids = enc.ids
        types = enc.type_ids
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
            types = types[: max_len - 1] + [types[max_len - 2] if max_len > 1 else 0]
        return ids, types


_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class HashTokenizer:
    """Deterministic file-free tokenizer for tests/bench."""

    def __init__(self, vocab_size: int = 30000):
        if vocab_size < 8:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.cls_id = 1
        self.sep_id = 2

    def _id(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.lower().encode()).digest()[:4], "little")
        return 3 + (h % (self.vocab_size - 3))

    def encode(self, text: str, max_len: int) -> List[int]:
        ids = [self.cls_id] + [self._id(w) for w in _WORD_RE.findall(text)] + [self.sep_id]
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
        return ids

    def encode_batch(self, texts: Sequence[str], max_len: int) -> List[List[int]]:
        return [self.encode(t, max_len) for t in texts]

    def encode_pair(self, a: str, b: str, max_len: int) -> Tuple[List[int], List[int]]:
        a_ids = [self._id(w) for w in _WORD_RE.findall(a)]
        b_ids = [self._id(w) for w in _WORD_RE.findall(b)]
        ids = [self.cls_id] + a_ids + [self.sep_id] + b_ids + [self.sep_id]
        types = [0] * (len(a_ids) + 2) + [1] * (len(b_ids) + 1)
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [self.sep_id]
            types = types[: max_len]
        return ids, types


def load_tokenizer(model_dir: str | Path | None, vocab_size: int = 30000) -> Tokenizer:
    """tokenizer.json from the model dir if present, else the hash tokenizer."""
    if model_dir is not None:
        f = Path(model_dir) / "tokenizer.json"
        if f.exists():
            return HFTokenizer(f)
    return HashTokenizer(vocab_size)
