"""Paged KV of the port: the JAX package's `symbiont_tpu/kv/`, three pieces,
bottom-up:

- `kv/paged.py`: the `PagedKVCache` layout (the third cache layout beside
  `models/gpt.py`'s dense `KVCache` and int8 `QuantKVCache`) and the
  scatter/gather ops the attention and the admission splice use; the pool
  tensors are written in place;
- `kv/pool.py`: the host-side page allocator over one preallocated device
  pool (free list, refcounts, the scratch page, LRU eviction of retained
  pages, the `kv.*` gauges);
- `kv/radix.py`: the refcounted radix prefix cache over committed prompt
  pages (numpy only), with copy-on-write forking, so an admission whose
  prompt hits a committed prefix shares its pages and a full hit skips
  its prefill.

`engine/lm.py` (sessions) and `models/gpt.py` (attention, `merge_rows`)
wire them in.
"""

from symbiont_tpu_torch.kv.paged import PagedKVCache  # noqa: F401
