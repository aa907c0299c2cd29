"""Length buckets + padding — the replacement for pad-everything-to-max.

A copy of `symbiont_tpu/engine/bucketing.py`: the port imports nothing of
the JAX package, so it keeps its own copy of this numpy-only module.

The reference pads every sentence to the model's max_position_embeddings (514
for mpnet) regardless of true length (reference:
services/preprocessing_service/src/embedding_generator.rs:83-91), so a 6-token
sentence pays a 514-token forward. SURVEY.md §5.7 sizes that waste at ~10-80×.
Here each sequence is padded only to the smallest configured bucket ≥ its
length, and batches are grouped per bucket; batch sizes are likewise bucketed
so the executable cache stays bounded at |length_buckets|×|batch_buckets|
entries (the "recompile storm" guard from SURVEY.md §7 hard-part #2).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def choose_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ length; the largest bucket if none (caller truncates)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to_bucket(
    seqs: Sequence[Sequence[int]], bucket: int, pad_id: int,
    dtype=np.int32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of token-id sequences to [n, bucket] ids + mask.

    `dtype` lets callers ship ids in the narrowest dtype the vocab allows
    (uint16 when vocab ≤ 65535) — halves h2d bytes; the device executable
    casts back to int32."""
    n = len(seqs)
    ids = np.full((n, bucket), pad_id, dtype)
    mask = np.zeros((n, bucket), np.int32)
    for i, s in enumerate(seqs):
        s = list(s[:bucket])
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask


def pad_batch_rows(
    ids: np.ndarray, mask: np.ndarray, batch_bucket: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad batch dim up to batch_bucket with all-pad rows; returns real count."""
    n = ids.shape[0]
    if n == batch_bucket:
        return ids, mask, n
    pad_rows = batch_bucket - n
    ids = np.concatenate([ids, np.tile(ids[-1:], (pad_rows, 1))], axis=0)
    mask = np.concatenate([mask, np.zeros((pad_rows, mask.shape[1]), np.int32)], axis=0)
    return ids, mask, n


def pad_ids_rows(
    seqs: Sequence[Sequence[int]], bucket: int, pad_id: int,
    dtype=np.int32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad token-id sequences to [n, bucket] ids + true lengths [n].

    The attention mask is NOT materialized on host: the device executable
    rebuilds it as `arange(bucket) < lengths[:, None]`, halving the
    host→device bytes vs shipping an explicit [n, bucket] mask — on a
    network-attached chip h2d bandwidth is part of the ingest wall.
    `dtype` further narrows the wire: uint16 ids when the vocab fits."""
    n = len(seqs)
    ids = np.full((n, bucket), pad_id, dtype)
    lengths = np.zeros((n,), np.int32)
    for i, s in enumerate(seqs):
        s = list(s[:bucket])
        ids[i, : len(s)] = s
        lengths[i] = len(s)
    return ids, lengths


def pad_batch_rows_ids(
    ids: np.ndarray, lengths: np.ndarray, batch_bucket: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-pad (ids, lengths) up to batch_bucket; padding rows get length 0
    (their pooled output is discarded). Returns real row count."""
    n = ids.shape[0]
    assert n <= batch_bucket, (
        f"batch of {n} rows exceeds its batch bucket {batch_bucket}")
    if n == batch_bucket:
        return ids, lengths, n
    pad_rows = batch_bucket - n
    ids = np.concatenate([ids, np.tile(ids[-1:], (pad_rows, 1))], axis=0)
    lengths = np.concatenate([lengths, np.zeros(pad_rows, np.int32)])
    return ids, lengths, n


def padding_stats(
    lengths: Sequence[int], bucket: int, batch_rows: int
) -> Tuple[int, int]:
    """(real_tokens, padded_slots) for one dispatched batch: how many of the
    `batch_rows * bucket` token slots the device will chew on carry real
    tokens vs bucket/row padding. Feeds the engine-plane padding-waste
    gauges (docs/OBSERVABILITY.md) — the quantified version of this module's
    whole reason to exist (SURVEY.md §5.7's 10-80x pad-to-max waste)."""
    real = int(sum(min(int(n), bucket) for n in lengths))
    return real, int(batch_rows) * int(bucket)


def plan_batches(
    lengths: Sequence[int],
    length_buckets: Sequence[int],
    max_batch: int,
) -> List[Tuple[int, List[int]]]:
    """Greedy plan: sort indices by length, group same-bucket runs into batches
    of ≤ max_batch. Returns [(length_bucket, [original indices]), ...]."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    plans: List[Tuple[int, List[int]]] = []
    cur_bucket = None
    cur: List[int] = []
    for idx in order:
        b = choose_bucket(lengths[idx], length_buckets)
        if b != cur_bucket or len(cur) >= max_batch:
            if cur:
                plans.append((cur_bucket, cur))
            cur_bucket, cur = b, []
        cur.append(idx)
    if cur:
        plans.append((cur_bucket, cur))
    return plans
