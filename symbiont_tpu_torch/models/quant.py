"""Weight quantization for the encoder forward: narrow weights at rest,
dequant folded into the consumer.

A port of `symbiont_tpu/models/quant.py` on torch tensors, with the same
storage modes (`EngineConfig.quantize`) and the same arithmetic:

- `f16`: floating leaves of rank ≥ 2 stored bfloat16;
- `int8`: symmetric per-channel int8, one float32 scale per entry of the
  LAST axis (an `[in, out]` kernel's output features, an embedding table's
  hidden dim); `mm` computes `(x @ q) * scale`, exact for per-output-channel
  scales;
- `fp8`: `torch.float8_e4m3fn` codes with the scale mapping each channel's
  amax to 448, the same fused-dequant contract.

Codes are made in float32 as the JAX package makes them: `w / scale`, then
`round` (half to even) for int8 and a plain cast for fp8, so they come out
bit-identical to the JAX package's on the same weights. Quantized matrix
products stay plain `torch.matmul`: the JAX package runs them in XLA, outside
any Pallas kernel, so there is no hand kernel to port here.

Rank-1 leaves (biases, norm parameters) are never quantized. A `QuantTensor`
is one leaf of the parameter tree: `tree_map` and `cast_params`
hand it over whole, so its float32 scales survive the compute-dtype cast.
"""

from __future__ import annotations

from typing import Any

import torch

from symbiont_tpu_torch.config import QUANTIZE_MODES as MODES

Params = Any

_INT8_AMAX = 127.0
_FP8_AMAX = 448.0  # float8_e4m3fn finite max


class QuantTensor:
    """A per-channel-quantized weight: `q` (int8 or float8_e4m3fn) and
    `scale` (float32, over the last axis). Its value is `q * scale`."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return tensor_bytes(self.q) + tensor_bytes(self.scale)

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.scale.to(device))

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def is_quantized(x) -> bool:
    return isinstance(x, QuantTensor)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_map(fn, tree):
    """`fn` on every leaf of a nested dict/list parameter tree (a
    `QuantTensor` is one leaf); `models.bert.tree_map`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree):
    """The leaves of a parameter tree, in its order (a `QuantTensor` is one)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """`t / c` rounded as IEEE division on every device. On CUDA, torch
    turns a division by a Python number into a product with its float32
    reciprocal, which can land one ulp away (and the codes after it one
    step away); a divisor on `t`'s own device is divided exactly."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def channel_quantize(w: torch.Tensor, amax: float, qdtype: torch.dtype) -> QuantTensor:
    """Symmetric per-channel quantization over the last axis, on `w`'s
    device, computed in float32."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=tuple(range(wf.ndim - 1))), amax)
    scale = scale.clamp_min(1e-12)
    q = wf / scale
    if not qdtype.is_floating_point:
        q = torch.round(q)  # half to even, as jnp.round
    return QuantTensor(q.to(qdtype), scale)


def quantize_params(params: Params, mode: str) -> Params:
    """Quantize every floating leaf of rank ≥ 2 per `mode`; rank-1 leaves
    stay as they are, and a leaf already quantized is kept."""
    if mode not in MODES:
        raise ValueError(f"quantize must be one of {MODES}, got {mode!r}")
    if mode == "none":
        return params

    def one(a):
        if isinstance(a, QuantTensor) or not (
                isinstance(a, torch.Tensor) and a.is_floating_point() and a.ndim >= 2):
            return a
        if mode == "f16":
            return a.to(torch.bfloat16)
        if mode == "int8":
            return channel_quantize(a, _INT8_AMAX, torch.int8)
        return channel_quantize(a, _FP8_AMAX, torch.float8_e4m3fn)

    return tree_map(one, params)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating leaves → `dtype` (a no-op on leaves already in it);
    `QuantTensor` leaves untouched, so their float32 scales stay float32."""
    def cast(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point() and a.dtype != dtype:
            return a.to(dtype)
        return a

    return tree_map(cast, params)


def narrow_params(params: Params, dtype: torch.dtype) -> Params:
    """Floating leaves wider than `dtype` → `dtype`; a leaf already as
    narrow stays as it is (f16's bf16 matrices under float32 compute, as the
    JAX engine keeps them), and `QuantTensor` leaves are untouched. The
    load-time cast that never widens a leaf."""
    bits = torch.finfo(dtype).bits

    def cast(a):
        if (isinstance(a, torch.Tensor) and a.is_floating_point()
                and torch.finfo(a.dtype).bits > bits):
            return a.to(dtype)
        return a

    return tree_map(cast, params)


def param_bytes(params: Params) -> int:
    """Bytes the parameter tree holds (codes and scales for a quantized
    leaf): the `engine.param_bytes` gauge and the `engine.params` claim."""
    total = 0
    for leaf in leaves(params):
        if isinstance(leaf, QuantTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += tensor_bytes(leaf)
    return total


def storage_label(params: Params) -> str:
    """What the tree holds in its matrices: "int8", "fp8", "bf16" or "f32"
    (the `dtype` label of `engine.param_bytes`)."""
    names = {torch.int8: "int8", torch.float8_e4m3fn: "fp8",
             torch.bfloat16: "bf16", torch.float32: "f32"}
    for leaf in leaves(params):
        if getattr(leaf, "ndim", 0) >= 2 and leaf.dtype in names:
            return names[leaf.dtype]
    return "f32"


# ------------------------------------------------------- fused-dequant ops


def _promoted(x: torch.Tensor, w: torch.Tensor):
    # jnp's matmul promotes mixed operands (bf16 @ f32 → f32); torch's raises
    if x.dtype == w.dtype:
        return x, w
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype), w.to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """`x @ w`; for a quantized `w`, `((x @ q) * scale)` in `x`'s dtype."""
    if isinstance(w, QuantTensor):
        return ((x @ w.q.to(x.dtype)) * w.scale).to(x.dtype)
    return torch.matmul(*_promoted(x, w))


def mm_tied(x: torch.Tensor, w) -> torch.Tensor:
    """`x @ w.T` for a tied embedding head. The scale axis is the
    contraction axis after the transpose, so it is applied to `x` first."""
    if isinstance(w, QuantTensor):
        return (x * w.scale).to(x.dtype) @ w.q.T.to(x.dtype)
    x, w = _promoted(x, w)
    return x @ w.T


def take(w, ids: torch.Tensor) -> torch.Tensor:
    """Embedding-table gather, indices clamped to the table as JAX's gathers
    clamp them; float32 `q[ids] * scale` for a quantized table."""
    ids = ids.clamp(0, w.shape[0] - 1)
    if isinstance(w, QuantTensor):
        return w.q[ids].float() * w.scale
    return w[ids]


def kv_channel_quantize(t: torch.Tensor, eps: float = 1e-8):
    """Quantize-on-append for an int8 KV cache: one scale per vector over
    the last axis (head_dim). Returns (q int8, scale float32 [...])."""
    tf = t.float()
    scale = _div(tf.abs().amax(dim=-1).clamp_min(eps), _INT8_AMAX)
    q = torch.round(tf / scale[..., None]).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Dequant-on-attend: int8 codes times their per-vector scales."""
    return (q.float() * scale[..., None]).to(dtype)
