"""Text cleaning, sentence splitting, word tokenization.

Copy of the JAX package's `symbiont_tpu/engine/text.py`.

Byte-for-byte behavioral parity with the reference's preprocessing core
(reference: services/preprocessing_service/src/main.rs:28-70), which SURVEY.md
§4 flags as untested-with-edge-cases there (multi-byte chars + byte-indexed
slicing). Python str indexing is codepoint-based so the multi-byte hazard
disappears, but the observable behavior matches:

- clean: split on whitespace, join with single spaces (main.rs:28-33);
- split: a sentence ends at each '.', '?' or '!' (delimiter kept, slice
  trimmed); trailing remainder becomes a final sentence; a non-empty text with
  no delimiters is one sentence (main.rs:41-62);
- empty cleaned text is an error at the caller (main.rs:33-39).
"""

from __future__ import annotations

from typing import List

SENTENCE_DELIMS = {".", "?", "!"}


def clean_text(raw: str) -> str:
    return " ".join(raw.split())


def split_sentences(cleaned: str) -> List[str]:
    sentences: List[str] = []
    start = 0
    for i, ch in enumerate(cleaned):
        if ch in SENTENCE_DELIMS:
            if i >= start:
                sentences.append(cleaned[start:i + 1].strip())
                start = i + 1
    if start < len(cleaned):
        remainder = cleaned[start:].strip()
        if remainder:
            sentences.append(remainder)
    if not sentences and cleaned:
        sentences.append(cleaned)
    return sentences


def tokenize_words(cleaned: str) -> List[str]:
    """Whitespace word tokens for the knowledge-graph path
    (TokenizedTextMessage.tokens; the KG stores lowercase-keyed Token nodes —
    reference: services/knowledge_graph_service/src/main.rs:100-125 — but the
    message carries the original-case words)."""
    return cleaned.split()
