"""Refcounted radix prefix cache over committed prompt pages.

The port's copy of `symbiont_tpu/kv/radix.py` (numpy only). A token trie
at page granularity: each node is one prompt block (the `kv_page_tokens`
ids covering cache slots `[b·page, (b+1)·page)` of a right-aligned prompt
row) and owns the pool page holding that block's K/V. An admission walks
the trie with its own prompt blocks; every matched node's page goes
straight into the new row's page table (refcount + 1) instead of being
written again. The first divergent block ends the walk: the row gets a
fresh private page there (the copy-on-write fork; the row's own prefill
scatter fills it, never the shared page).

Roots are keyed by `(prompt_bucket, pad)`: right alignment makes a slot's
K/V depend on its logical position (slot − pad), so only rows of equal
prompt length inside one bucket can share pages.

A full-prompt terminal also stores the last token's logits (host numpy, one
[vocab] row), so an admission whose whole prompt is committed skips its
prefill: pages wired, logits restored.

Eviction: committed pages whose refcount is 0 are retained by the pool and
evicted LRU under allocation pressure (`PagePool._evict_lru_locked` →
`forget_page` here → the page's whole subtree decommits, since a block is
meaningless without its prefix).

Locking: every method runs under the pool's RLock (`self._lock` is
`pool.lock`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from symbiont_tpu_torch.kv.pool import PagePool


class _Node:
    __slots__ = ("parent", "key", "page", "children", "logits")

    def __init__(self, parent: Optional["_Node"], key, page: int):
        self.parent = parent
        self.key = key              # the block's token ids
        self.page = page            # the pool page holding its K/V
        self.children: Dict[tuple, "_Node"] = {}
        self.logits: Optional[np.ndarray] = None  # full-prompt terminal


class Match(NamedTuple):
    """One row's walk: the committed page per matched block (block order
    from 0) and, when every prompt block matched and the terminal stored
    logits, those logits (a full hit: the prefill is skipped)."""

    pages: List[int]
    logits: Optional[np.ndarray]

    @property
    def blocks(self) -> int:
        return len(self.pages)


class RadixCache:
    def __init__(self, pool: PagePool, page_tokens: int):
        self.pool = pool
        self.page = int(page_tokens)
        self._lock = pool.lock
        self._roots: Dict[Tuple[int, int], _Node] = {}  # (P, pad) → root
        self._page_nodes: Dict[int, _Node] = {}
        pool._on_evict = self.forget_page
        self.stats = {"hits": 0, "full_hits": 0, "misses": 0, "committed_pages": 0}

    def _blocks(self, row_ids: np.ndarray) -> List[tuple]:
        return [tuple(int(t) for t in row_ids[b:b + self.page])
                for b in range(0, len(row_ids), self.page)]

    def match(self, P: int, pad: int, row_ids: np.ndarray) -> Match:
        """Walk the trie with one right-aligned prompt row [P]. Matched
        pages are LRU-touched but not retained: the caller retains exactly
        the pages it wires (a refused admission must not leak refcounts)."""
        with self._lock:
            node = self._roots.get((P, pad))
            pages: List[int] = []
            for key in self._blocks(row_ids):
                node = node.children.get(key) if node is not None else None
                if node is None:
                    break
                pages.append(node.page)
                self.pool.touch(node.page)
            full = node is not None and len(pages) == P // self.page and node.logits is not None
            self.stats["hits" if pages else "misses"] += 1
            if full:
                self.stats["full_hits"] += 1
            return Match(pages, node.logits if full else None)

    def peek(self, P: int, pad: int, row_ids: np.ndarray) -> int:
        """Side-effect-free probe: how many tokens of one right-aligned
        prompt row [P] are resident (nothing touched, no stats moved)."""
        with self._lock:
            node = self._roots.get((P, pad))
            blocks = 0
            for key in self._blocks(row_ids):
                node = node.children.get(key) if node is not None else None
                if node is None:
                    break
                blocks += 1
            return max(0, blocks * self.page - int(pad))

    def commit(self, P: int, pad: int, row_ids: np.ndarray, block_pages: List[int],
               logits: Optional[np.ndarray] = None) -> None:
        """Commit one admitted row's prompt blocks. `block_pages[b]` is the
        page now backing block b in the row's page table (shared pages for
        matched blocks, the row's fresh pages past the fork). New nodes
        adopt the fresh pages (they outlive the row); blocks already
        committed keep their page, and the row's duplicate stays private
        and frees with the row."""
        with self._lock:
            node = self._roots.setdefault((P, pad), _Node(None, (), -1))
            for b, key in enumerate(self._blocks(row_ids)):
                child = node.children.get(key)
                if child is None:
                    child = _Node(node, key, block_pages[b])
                    node.children[key] = child
                    self.pool.commit(block_pages[b])
                    self._page_nodes[block_pages[b]] = child
                    self.stats["committed_pages"] += 1
                node = child
            if logits is not None:
                node.logits = np.asarray(logits, np.float32).copy()

    def forget_page(self, pid: int) -> None:
        """Evict the trie subtree rooted at pid's node (the pool's LRU
        callback)."""
        with self._lock:
            node = self._page_nodes.pop(pid, None)
            if node is None:  # already gone with an earlier subtree
                self.pool.decommit(pid)
                return
            if node.parent is not None:
                node.parent.children.pop(node.key, None)
            stack = [node]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                n.children.clear()
                self._page_nodes.pop(n.page, None)
                self.stats["committed_pages"] -= 1
                self.pool.decommit(n.page)

    def clear(self) -> None:
        """Drop every committed prefix (a parameter swap: cached K/V and
        logits are stale under the new weights)."""
        with self._lock:
            for pid in list(self._page_nodes):
                self.forget_page(pid)
            self._roots.clear()
