"""Flash-attention forward: the CUDA kernel's wrapper, its plain version
and its launch count.

Replaces the Pallas TPU kernel `_kernel` (launched by `_flash_call`) of
`symbiont_tpu/ops/flash_attention.py`, keeping the JAX signature and
layout: q `[B, NH, Sq, D]`, k/v `[B, NKV, Sk, D]` with NKV dividing NH
(GQA, q head h reads kv head h // (NH // NKV)), an additive float32 per-key
bias `[B, Sk]` (0 for real keys, -1e9 for padding), output in q's dtype
and the float32 log-sum-exp `[B, NH, Sq, 1]` that the backward kernels of a
later slice read.

The kernel is `csrc/flash_attn_fwd.cu` (built by `_build.py`); its header
says what bounds it on an H100 and what its design does about that. On a
CUDA tensor the wrapper launches it or raises; on a CPU tensor it runs
`flash_attention_reference`, the plain PyTorch version of the same function
(the JAX package's `_dense_reference`), which the CPU tests hold against
the JAX kernel and `chip_smoke.py` holds the CUDA kernel against.

The JAX kernel's dense fallback for lengths no power-of-two block divides
(`_pick_block`) is a TPU tiling limit; the CUDA kernel masks the ragged
edge itself and takes any length.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from symbiont_tpu_torch.ops import _build

# Large-negative finite stand-in for -inf used for masked keys — the JAX
# kernel's _MASK_NEG. No -inf anywhere, so a fully masked row stays finite.
MASK_NEG = -1e9
HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset (chip_smoke.py sets it to 0 before
# driving the main path and reads it after). Counts launches only: the CPU
# path through the plain version does not count.
launches = 0


def _check(q, k, v, kv_bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, heads, S, D]")
    B, NH, _, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if NH % k.shape[1] != 0:
        raise ValueError(f"q heads {NH} not a multiple of kv heads {k.shape[1]}")
    if kv_bias is not None and tuple(kv_bias.shape) != (B, k.shape[2]):
        raise ValueError(f"kv_bias must be [B, Sk] = {(B, k.shape[2])}, "
                         f"got {tuple(kv_bias.shape)}")


def flash_attention_reference(q, k, v, kv_bias=None, causal=False,
                              scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention in float32 → (out in q's dtype, lse f32
    [B, NH, Sq, 1]). Follows the JAX `_dense_reference`: K/V repeated for
    GQA, scores + bias, causal positions replaced by -1e9, softmax."""
    _check(q, k, v, kv_bias)
    B, NH, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if NH != NKV:
        k = k.repeat_interleave(NH // NKV, dim=1)
        v = v.repeat_interleave(NH // NKV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    if causal:
        visible = (torch.arange(Sq, device=q.device)[:, None]
                   >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(visible, s, torch.full_like(s, MASK_NEG))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


def flash_attention_with_lse(q, k, v, kv_bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention → (out [B, NH, Sq, D] in q's dtype, lse f32
    [B, NH, Sq, 1]). CUDA tensors go through the kernel; CPU tensors
    through the plain version."""
    _check(q, k, v, kv_bias)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_bias, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, NH, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim {HEAD_DIMS}, got {D}")
    if kv_bias is None:
        kv_bias = torch.zeros((B, Sk), dtype=torch.float32, device=q.device)
    if kv_bias.dtype != torch.float32:
        raise TypeError(f"kv_bias must be float32, got {kv_bias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_bias", kv_bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, NH, Sq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _build.load().symbiont_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, NH, NKV, Sq, Sk, D,
            int(q.dtype == torch.bfloat16), int(bool(causal)), float(scale),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {rc} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    global launches
    launches += 1
    return out, lse


def flash_attention(q, k, v, kv_bias: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention → [B, NH, Sq, D] in q's dtype (the JAX
    `flash_attention` signature, minus its TPU block and interpret knobs)."""
    return flash_attention_with_lse(q, k, v, kv_bias, causal, scale)[0]
