"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, their launch counts and the autograd Function over them.

Replaces the Pallas TPU kernels of `symbiont_tpu/ops/flash_attention.py`:
`_kernel` (the forward, launched by `_flash_call`), `_bwd_kv_kernel` and
`_bwd_q_kernel` (the fused backward, launched by `_flash_bwd_fused`), and
the `_flash` custom_vjp that ties them together. The JAX signature and
layout are kept: q `[B, NH, Sq, D]`, k/v `[B, NKV, Sk, D]` with NKV
dividing NH (GQA, q head h reads kv head h // (NH // NKV)), an additive
float32 per-key bias `[B, Sk]` (0 for real keys, -1e9 for padding), output
in q's dtype and the float32 log-sum-exp `[B, NH, Sq, 1]`.

The kernels are `csrc/flash_attn_fwd.cu` and `csrc/flash_attn_bwd.cu`
(built by `_build.py`); their headers say what bounds them on an H100 and
what their design does about that. On a CUDA tensor each wrapper launches
its kernel or raises; on a CPU tensor it runs the plain PyTorch version of
the same function, which the CPU tests hold against the JAX kernels and
`chip_smoke.py` holds the CUDA kernels against.

Autograd: when grad mode is on and an input requires grad, the forward
goes through `_FlashAttention`, whose backward is the fused pair (dK/dV/
dbias, then dQ) for NH == NKV and, for GQA, the dense float32 recompute of
the JAX `_flash_bwd`. Otherwise (inference mode, no grad) the forward
kernel runs alone and nothing is kept past the call.

The JAX kernel's dense fallback for lengths no power-of-two block divides
(`_pick_block`) is a TPU tiling limit; the CUDA kernels mask the ragged
edge themselves and take any length, so the fused backward serves every
shape with NH == NKV.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch

from symbiont_tpu_torch.ops import _build

# Large-negative finite stand-in for -inf used for masked keys — the JAX
# kernel's _MASK_NEG. No -inf anywhere, so a fully masked row stays finite.
MASK_NEG = -1e9
HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset (chip_smoke.py sets them to 0 before
# driving the main path and reads them after). They count launches only:
# the CPU path through the plain versions does not count. Two threads can
# launch at once (the stack's embed batcher keeps two flushes in flight), so
# each count moves under `_count_lock`.
#
# A call made while the current stream captures a CUDA graph launches
# nothing: it records the kernel into the graph. It goes to that stream's
# tally instead (`take_captured`), and every replay of that graph adds the
# tally to the counts (`note_replay`), so a replayed launch counts once per
# replay, where the device runs it. The tally is the stream's, not the
# thread's: a captured backward launches B2 and B3 from autograd's device
# thread, on the capturing stream.
_count_lock = threading.Lock()
launches = 0          # forward, csrc/flash_attn_fwd.cu
bwd_kv_launches = 0   # dK/dV/dbias, csrc/flash_attn_bwd.cu
bwd_q_launches = 0    # dQ, csrc/flash_attn_bwd.cu
_captured: dict = {}  # capturing stream handle -> [B1, B2, B3] recorded


def _count(i: int) -> None:
    """One launch of kernel i (0 B1, 1 B2, 2 B3), or, under a capture on
    the current stream, one kernel recorded into the graph."""
    global launches, bwd_kv_launches, bwd_q_launches
    if torch.cuda.is_current_stream_capturing():
        with _count_lock:
            _captured.setdefault(torch.cuda.current_stream().cuda_stream, [0, 0, 0])[i] += 1
        return
    with _count_lock:
        if i == 0:
            launches += 1
        elif i == 1:
            bwd_kv_launches += 1
        else:
            bwd_q_launches += 1


def take_captured(stream=None) -> Tuple[int, int, int]:
    """The kernels recorded on `stream` (the current one by default) since
    the last call: (B1, B2, B3) per replay of the graph just captured
    there. Resets its tally."""
    if stream is None and not torch.cuda.is_available():
        return (0, 0, 0)  # nothing captures without CUDA
    handle = (stream or torch.cuda.current_stream()).cuda_stream
    with _count_lock:
        return tuple(_captured.pop(handle, [0, 0, 0]))


def note_replay(counts: Tuple[int, int, int], replays: int = 1) -> None:
    """`replays` replays of a graph that holds `counts` kernels."""
    global launches, bwd_kv_launches, bwd_q_launches
    if not any(counts):
        return
    with _count_lock:
        launches += counts[0] * replays
        bwd_kv_launches += counts[1] * replays
        bwd_q_launches += counts[2] * replays


# The work of the kernels launched on a stream while a cost count is open
# there (`count_work`): an executable's cost analysis counts its aten ops
# under a dispatch mode, which the ctypes launches bypass, so each launch
# adds its kernel's operations and bytes by the formulas of its bound.
_work: dict = {}  # stream handle (thread id without CUDA) -> [flops, bytes]


def _work_key():
    # no kernel runs before CUDA is initialised; `is_available` would start
    # the driver, a fraction of a second, in a process that never uses it
    if torch.cuda.is_initialized():
        return torch.cuda.current_stream().cuda_stream
    return threading.get_ident()


def kernel_work(i: int, q: torch.Tensor, k: torch.Tensor, causal: bool) -> Tuple[float, int]:
    """(operations, bytes) of one launch of kernel i (0 B1, 1 B2, 2 B3) on
    q `[B, NH, Sq, D]` and k `[B, NKV, Sk, D]`: B1 4, B2 8, B3 6 ·
    B·NH·pairs·D operations (pairs Sq·Sk, the visible ones when causal);
    each input read once and each output written once (B1: q, k, v, the
    f32 bias in, o and the f32 lse out; B2 and B3: q, k, v, g, the bias,
    lse and δ in, dk, dv and the per-head f32 dbias out of B2, dq out of
    B3)."""
    B, NH, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    es = q.element_size()
    if causal:
        n = min(Sq, Sk)
        pairs = n * (n + 1) // 2 + (Sq - n) * Sk
    else:
        pairs = Sq * Sk
    if i == 0:
        return (4.0 * B * NH * pairs * D,
                2 * B * NH * Sq * D * es + 2 * B * NKV * Sk * D * es + B * Sk * 4
                + B * NH * Sq * 4)
    ins = 2 * B * NH * (Sq + Sk) * D * es + B * Sk * 4 + 2 * B * NH * Sq * 4
    if i == 1:
        return 8.0 * B * NH * pairs * D, ins + 2 * B * NH * Sk * D * es + B * NH * Sk * 4
    return 6.0 * B * NH * pairs * D, ins + B * NH * Sq * D * es


def _note_work(i: int, q, k, causal: bool) -> None:
    """One launch of kernel i into the cost count open on this stream."""
    if not _work:
        return
    key = _work_key()
    with _count_lock:
        tally = _work.get(key)
        if tally is not None:
            flops, nbytes = kernel_work(i, q, k, causal)
            tally[0] += flops
            tally[1] += nbytes


@contextlib.contextmanager
def count_work():
    """Count the kernels launched on the current stream inside the block:
    yields the [flops, bytes] tally."""
    key = _work_key()
    tally = [0.0, 0]
    with _count_lock:
        _work[key] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            _work.pop(key, None)


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


def _check_kernel_inputs(q, tensors) -> None:
    """What the CUDA kernels take: f32 or bf16, one dtype for the
    attention operands, head dim 32/64/128, float32 bias/lse, one device,
    contiguous and 16-byte aligned."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels take head dim {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    for name, t in tensors.items():
        want = torch.float32 if name in ("kv_bias", "lse") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _bias_or_zeros(q, k, kv_bias):
    if kv_bias is None:
        return torch.zeros((q.shape[0], k.shape[2]), dtype=torch.float32,
                           device=q.device)
    return kv_bias


def _scores(q, k, kv_bias, causal, scale):
    """float32 s = q·kᵀ·scale + bias, causal positions replaced by -1e9 —
    the scores both JAX paths (dense and fused) build, in their order."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_bias is not None:
        s = s + kv_bias.float()[:, None, None, :]
    if causal:
        visible = (torch.arange(Sq, device=q.device)[:, None]
                   >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(visible, s, torch.full_like(s, MASK_NEG))
    return s


def _repeat_kv(q, k, v):
    group = q.shape[1] // k.shape[1]
    if group == 1:
        return k, v
    return k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)


def flash_attention_reference(q, k, v, kv_bias=None, causal=False,
                              scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention in float32 → (out in q's dtype, lse f32
    [B, NH, Sq, 1]). Follows the JAX `_dense_reference`: K/V repeated for
    GQA, scores + bias, causal positions replaced by -1e9, softmax."""
    _check(q, k, v, kv_bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(q, k, v)
    s = _scores(q, k, kv_bias, causal, scale)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


def _p_ds(q, k, v, kv_bias, g, lse, delta, causal, scale):
    """float32 p = exp(s - lse) from the GIVEN lse, as the JAX fused
    kernels rebuild it (not a softmax), and dS = p∘(g·vᵀ - δ)."""
    p = torch.exp(_scores(q, k, kv_bias, causal, scale) - lse.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None])


def bwd_kv_reference(q, k, v, kv_bias, g, lse, delta, causal, scale):
    """Plain version of the dK/dV/dbias kernel (`_bwd_kv_kernel`) →
    (dk, dv in k/v's dtypes, per-head dbias f32 [B, NH, Sk]). `delta` is
    rowsum(g∘o), f32 [B, NH, Sq]. p and dS are rounded down to the inputs'
    dtype before the products with g and q; dbias takes dS unrounded."""
    p, ds = _p_ds(q, k, v, kv_bias, g, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2)


def bwd_q_reference(q, k, v, kv_bias, g, lse, delta, causal, scale):
    """Plain version of the dQ kernel (`_bwd_q_kernel`) → dq in q's
    dtype, with dS rounded down to k's dtype before the product with k."""
    _, ds = _p_ds(q, k, v, kv_bias, g, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def bwd_delta(g, out):
    """δ = rowsum(g∘o) in float32, [B, NH, Sq] — computed outside the
    kernels, as the JAX `_flash_bwd_fused` does."""
    return (g.float() * out.float()).sum(-1)


def flash_attention_backward_reference(q, k, v, kv_bias, out, lse, g,
                                       causal=False, scale=None):
    """Plain version of the fused backward (NH == NKV) → (dq, dk, dv in
    the inputs' dtypes, dbias f32 [B, Sk] summed over heads).

    Follows the JAX `_bwd_kv_kernel`/`_bwd_q_kernel`, not a softmax
    gradient: p = exp(s - lse) from the GIVEN lse, δ = rowsum(g∘o), and p
    and dS rounded down to the inputs' dtype before the products with g, q
    and k. So on a row whose keys are all masked (s and lse both ~-1e9 in
    float32) p is 1 for every key, as in the JAX kernels, and the gradient
    there is Sk times the dense one."""
    _check(q, k, v, kv_bias)
    if q.shape[1] != k.shape[1]:
        raise ValueError("the fused backward takes NH == NKV; GQA takes the "
                         "dense recompute")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = bwd_delta(g, out)
    dk, dv, dbias_h = bwd_kv_reference(q, k, v, kv_bias, g, lse, delta, causal, scale)
    dq = bwd_q_reference(q, k, v, kv_bias, g, lse, delta, causal, scale)
    return dq, dk, dv, dbias_h.sum(1)


def _dense_backward(q, k, v, kv_bias, g, causal, scale):
    """The JAX `_flash_bwd` dense float32 recompute (its GQA path): softmax
    gradient with K/V repeated, dK/dV summed over each kv head's q heads."""
    B, NH, _, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    kr, vr = _repeat_kv(q, k, v)
    p = torch.softmax(_scores(q, kr, kv_bias, causal, scale), dim=-1)
    gf = g.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vr.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    if NH != NKV:
        dk = dk.reshape(B, NKV, NH // NKV, Sk, D).sum(2)
        dv = dv.reshape(B, NKV, NH // NKV, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=(1, 2))


def _forward(q, k, v, kv_bias, causal, scale):
    """One forward: the kernel on CUDA tensors, the plain version on CPU
    ones. `kv_bias` is a tensor here (zeros when the caller gave none)."""
    if _device(q) == "cpu":
        return flash_attention_reference(q, k, v, kv_bias, causal, scale)
    B, NH, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    _check_kernel_inputs(q, {"q": q, "k": k, "v": v, "kv_bias": kv_bias})
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
    _note_work(0, q, k, causal)
    _count(0)
    return out, lse


def bwd_kv(q, k, v, kv_bias, g, lse, delta, causal, scale):
    """The dK/dV/dbias kernel on CUDA tensors → (dk, dv, per-head dbias f32
    [B, NH, Sk]); arguments as `bwd_kv_reference`, checked by the caller."""
    B, NH, Sq, D = q.shape
    Sk = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias_h = torch.empty((B, NH, Sk), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.load().symbiont_flash_attn_bwd_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias_h.data_ptr(), B, NH, Sq, Sk, D,
            int(q.dtype == torch.bfloat16), int(bool(causal)), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_kv launch failed: cudaError {rc} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    _note_work(1, q, k, causal)
    _count(1)
    return dk, dv, dbias_h


def bwd_q(q, k, v, kv_bias, g, lse, delta, causal, scale):
    """The dQ kernel on CUDA tensors → dq; arguments as `bwd_kv`."""
    B, NH, Sq, D = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _build.load().symbiont_flash_attn_bwd_q(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, NH, Sq, k.shape[2], D, int(q.dtype == torch.bfloat16),
            int(bool(causal)), float(scale), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_q launch failed: cudaError {rc} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    _note_work(2, q, k, causal)
    _count(2)
    return dq


def flash_attention_backward(q, k, v, kv_bias, out, lse, g, causal=False,
                             scale=None):
    """Fused backward for NH == NKV → (dq, dk, dv, dbias f32 [B, Sk]).
    CUDA tensors go through the two kernels (δ first, then dK/dV/dbias,
    then dQ); CPU tensors through `flash_attention_backward_reference`."""
    _check(q, k, v, kv_bias)
    if q.shape[1] != k.shape[1]:
        raise ValueError("the fused backward takes NH == NKV; GQA takes the "
                         "dense recompute")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _device(q) == "cpu":
        return flash_attention_backward_reference(q, k, v, kv_bias, out, lse, g,
                                                  causal, scale)
    kv_bias = _bias_or_zeros(q, k, kv_bias)
    _check_kernel_inputs(q, {"q": q, "k": k, "v": v, "kv_bias": kv_bias,
                             "out": out, "lse": lse, "g": g})
    delta = bwd_delta(g, out)
    dk, dv, dbias_h = bwd_kv(q, k, v, kv_bias, g, lse, delta, causal, scale)
    dq = bwd_q(q, k, v, kv_bias, g, lse, delta, causal, scale)
    return dq, dk, dv, dbias_h.sum(1)  # per-head dbias summed over heads


class _FlashAttention(torch.autograd.Function):
    """The JAX `_flash` custom_vjp. Residuals follow `_flash_fwd`: out and
    lse are kept only when the fused backward will read them (NH == NKV);
    GQA takes the dense recompute, which needs neither."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, scale):
        out, lse = _forward(q, k, v, kv_bias, causal, scale)
        fused = q.shape[1] == k.shape[1]
        ctx.save_for_backward(q, k, v, kv_bias, out if fused else None,
                              lse if fused else None)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()  # back through transpose(1, 2) it usually is not
        if out is not None:
            dq, dk, dv, dbias = flash_attention_backward(
                q, k, v, kv_bias, out, lse, g, ctx.causal, ctx.scale)
        else:
            dq, dk, dv, dbias = _dense_backward(q, k, v, kv_bias, g, ctx.causal,
                                                ctx.scale)
        dbias = dbias.to(kv_bias.dtype) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None


def flash_attention_with_lse(q, k, v, kv_bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention → (out [B, NH, Sq, D] in q's dtype, lse f32
    [B, NH, Sq, 1]). CUDA tensors go through the kernels; CPU tensors
    through the plain versions. Differentiable in q, k, v and kv_bias
    (lse carries no gradient)."""
    _check(q, k, v, kv_bias)
    _device(q)
    kv_bias = _bias_or_zeros(q, k, kv_bias)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, kv_bias)):
        return _FlashAttention.apply(q, k, v, kv_bias, bool(causal), scale)
    return _forward(q, k, v, kv_bias, bool(causal), scale)


def flash_attention(q, k, v, kv_bias: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention → [B, NH, Sq, D] in q's dtype (the JAX
    `flash_attention` signature, minus its TPU block and interpret knobs)."""
    return flash_attention_with_lse(q, k, v, kv_bias, causal, scale)[0]
