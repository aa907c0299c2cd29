"""PagedKVCache: the third KV-cache layout, after the dense `KVCache` and
the int8 `QuantKVCache` of `models/gpt.py`.

The port of `symbiont_tpu/kv/paged.py`. K/V live in one preallocated
device pool of fixed-size pages, `[L, n_pages, page, kv_heads, head_dim]`,
and each batch row maps its cache-index space onto pool pages through a
page table `[B, n_blocks]` (block b covers cache slots
`[b·page, (b+1)·page)`). The logical cache-index space is the dense
layout's: prompts stay right-aligned, every row shares the scalar
`length`, causality and `kv_valid` are unchanged. Attention gathers the
pool through the page table into exactly the `[B, T, kv_heads, head_dim]`
tensor the dense path reads, element for element, so paged decode is
token-identical to dense decode for both `kv_quant` modes.

Page 0 is a scratch sink: rows with nothing mapped at a block (padding
rows, freed rows, decode blocks not allocated yet) point there. What lands
in it is garbage; what is read from it is always masked (causality,
`kv_valid`, or a padding row's discarded output).

Where JAX donates the pools through every call, the port writes them in
place (`index_put_` on the flattened token axis), and `length` is a host
int, as in the port's other two layouts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SCRATCH_PAGE = 0  # reserved sink page; never allocated, never trusted


class PagedKVCache(NamedTuple):
    """Pool tensors, page table and the dense-compatible `length`.

    `k`/`v`: [L, n_pages, page, kv_heads, head_dim] (the compute dtype, or
    int8 with `kv_quant="int8"`). `k_scale`/`v_scale`: float32 [L, n_pages,
    page, kv_heads] (a zero-size page axis when unquantized, so one tuple
    covers both). `page_table`: [B, n_blocks] int64 into the page axis.
    `length`: slots written, a host int."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    page_table: torch.Tensor
    length: int

    @property
    def page_tokens(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_pool_arrays(num_layers: int, n_pages: int, page: int, kv_heads: int,
                     head_dim: int, dtype: torch.dtype, quantized: bool, device=None):
    """Zeroed pools (k, v, k_scale, v_scale). The zeros matter: a scratch
    read before any write must be finite, since it multiplies an exactly
    zero masked probability."""
    shape = (num_layers, n_pages, page, kv_heads, head_dim)
    sshape = (num_layers, n_pages if quantized else 0, page, kv_heads)
    kv_dtype = torch.int8 if quantized else dtype
    return (torch.zeros(shape, dtype=kv_dtype, device=device),
            torch.zeros(shape, dtype=kv_dtype, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device))


def flat_slot_index(page_table: torch.Tensor, slots: torch.Tensor, page: int) -> torch.Tensor:
    """Cache slots [S] → flat pool indices [B, S] over the flattened
    (n_pages·page) token axis, through the page table."""
    pids = page_table[:, slots // page]  # [B, S]
    return pids * page + (slots % page)[None, :]


def scatter_prompt(pool_k, pool_v, pool_ks, pool_vs, staged, page_table_b: torch.Tensor,
                   prompt_width: int):
    """Adopt a dense-staged prefill into the pool, in place: every staged
    row's prompt region [0, prompt_width) goes into the pages its row of
    `page_table_b` maps, one scatter per field across all layers (the layer
    offset is folded into the flat index). `page_table_b` is the scatter
    table, not the row's real page table: it maps only the row's fresh
    blocks, with radix-shared blocks (and rows not admitted) pointed at the
    scratch page, because committed pages are being read by other live
    sessions and are never rewritten.

    `staged` is a dense `KVCache` or `QuantKVCache`. Returns the four pools
    (the same tensors)."""
    L, NP, page = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    P = prompt_width
    slots = torch.arange(P, device=pool_k.device)
    flat = flat_slot_index(page_table_b.to(pool_k.device).long(), slots, page)  # [B2, P]
    lflat = flat[None] + (torch.arange(L, device=pool_k.device) * NP * page)[:, None, None]

    def scat(pool, vals):  # pool as [L·n_pages·page, ...], a view
        pool.flatten(0, 2)[lflat] = vals.to(pool.dtype)

    scat(pool_k, staged.k[:, :, :P])
    scat(pool_v, staged.v[:, :, :P])
    if pool_ks.shape[1] > 0:  # int8: the scale pools ride along
        scat(pool_ks, staged.k_scale[:, :, :P])
        scat(pool_vs, staged.v_scale[:, :, :P])
    return pool_k, pool_v, pool_ks, pool_vs


def splice_rows(row_map, n_b: int, device):
    """Host `row_map` [B] → (destination rows, source rows) as int64
    tensors on `device`: row i takes b's row row_map[i] where that is
    >= 0."""
    rm = np.asarray(row_map.cpu() if isinstance(row_map, torch.Tensor) else row_map,
                    np.int64)
    dst = np.nonzero(rm >= 0)[0]
    if dst.size and int(rm[dst].max()) >= n_b:
        raise ValueError(f"row_map {rm.tolist()} names a row past the {n_b} prepared ones")
    return (torch.from_numpy(dst).to(device), torch.from_numpy(rm[dst]).to(device))


def merge_row_state(logits_a, pos_a, done_a, kv_valid_a, logits_b, pos_b, done_b, kv_valid_b,
                    row_map, length: int, prompt_width: int):
    """The row-state half of a paged splice, in place on state a: row i
    takes b's row row_map[i] where that is >= 0, with `merge_rows`' gap
    contract (a spliced row's slots [prompt_width, length), the steps the
    session decoded before the admission, stay invalid). The cache half
    happens in the pool (`scatter_prompt` and the host page table); the
    dense layouts' `merge_rows` shares this half. Returns state a's four
    tensors."""
    T = kv_valid_a.shape[1]
    t_idx = torch.arange(T, device=kv_valid_b.device)
    gap = (t_idx >= prompt_width) & (t_idx < length)
    kv_b = kv_valid_b & ~gap[None, :]
    dst, src = splice_rows(row_map, logits_b.shape[0], logits_a.device)
    if dst.numel():
        for a, b in ((logits_a, logits_b), (pos_a, pos_b), (done_a, done_b),
                     (kv_valid_a, kv_b)):
            a.index_copy_(0, dst, b.index_select(0, src))
    return logits_a, pos_a, done_a, kv_valid_a
