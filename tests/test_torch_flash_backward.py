"""Gradients through the port's flash attention on the CPU against the JAX
package's fused Pallas backward (`_bwd_kv_kernel` + `_bwd_q_kernel`, run in
interpret mode) on the same numpy inputs and the same output cotangent.

On CPU tensors the port's autograd Function runs the plain versions
(`flash_attention_backward_reference`, and the dense recompute for GQA);
chip_smoke.py holds the CUDA backward kernels against the same plain
version on the card. Bar: float32 rtol 2e-4 / atol 2e-4, the bar of
tests/test_ops_flash.py. S ≤ 128 and D ≤ 32 keep interpret mode fast."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.ops.flash_attention import (
    _dense_reference,
    _flash_bwd_fused,
    _flash_call,
    flash_attention as jax_flash,
)
from symbiont_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, B, NH, NKV, Sq, Sk, D, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, NKV, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, NKV, Sk, D), dtype=np.float32)
    w = rng.standard_normal((B, NH, Sq, D), dtype=np.float32)  # d loss / d out
    bias = np.where(np.arange(Sk)[None, :] < np.asarray(lengths)[:, None], 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias, w


def _jax_grads(q, k, v, bias, w, causal=False, bq=32, bk=32, dtype=jnp.float32):
    def loss(q, k, v, bias):
        out = jax_flash(q, k, v, kv_bias=bias, causal=causal, block_q=bq,
                        block_k=bk, interpret=True)
        return (out.astype(jnp.float32) * w).sum()

    args = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(bias)]
    return [np.asarray(x, np.float32)
            for x in jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


def _dense_grads(q, k, v, bias, w, causal=False):
    def loss(q, k, v):
        out, _ = _dense_reference(q, k, v, jnp.asarray(bias), causal,
                                  1 / math.sqrt(q.shape[-1]))
        return (out * w).sum()

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, bias, w, causal=False, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    b = torch.from_numpy(bias).requires_grad_()
    out = fa.flash_attention(*t, kv_bias=b, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [x.grad for x in t] + [b.grad]


def _assert_grads(got, want, names="dq dk dv dbias", **tol):
    for name, a, b in zip(names.split(), got, want):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name, **(tol or TOL))


def test_padded_non_causal_matches_fused_kernels():
    q, k, v, bias, w = _inputs(0, 2, 2, 2, 64, 64, 32, lengths=[64, 23])
    out, got = _port_grads(q, k, v, bias, w)
    _assert_grads(got, _jax_grads(q, k, v, bias, w))
    _assert_grads(got[:3], _dense_grads(q, k, v, bias, w), names="dq dk dv")
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


def test_causal_multiblock_asymmetric_blocks_match():
    # as tests/test_ops_flash.py: causal, several blocks per axis, bq != bk
    q, k, v, bias, w = _inputs(1, 2, 2, 2, 128, 128, 32, lengths=[128, 77])
    _, got = _port_grads(q, k, v, bias, w, causal=True)
    _assert_grads(got, _jax_grads(q, k, v, bias, w, causal=True, bq=64, bk=32))


def test_sq_ne_sk_matches():
    q, k, v, bias, w = _inputs(2, 2, 2, 2, 32, 96, 32, lengths=[96, 40])
    _, got = _port_grads(q, k, v, bias, w)
    _assert_grads(got, _jax_grads(q, k, v, bias, w))


def test_bias_gradient_matches():
    # a non-trivial bias (no padding): every key's dbias is a real sum
    q, k, v, _, w = _inputs(3, 2, 2, 2, 64, 64, 32, lengths=[64, 64])
    bias = np.random.default_rng(30).standard_normal((2, 64)).astype(np.float32)
    _, got = _port_grads(q, k, v, bias, w)
    want = _jax_grads(q, k, v, bias, w)
    assert np.abs(want[3]).max() > 1e-2
    _assert_grads(got, want)
    assert got[3].dtype == torch.float32 and got[3].shape == (2, 64)


def test_gqa_takes_dense_recompute_and_matches():
    q, k, v, bias, w = _inputs(4, 1, 4, 2, 64, 64, 32, lengths=[50])
    out, got = _port_grads(q, k, v, bias, w, causal=True)
    _assert_grads(got, _jax_grads(q, k, v, bias, w, causal=True))
    _assert_grads(got[:3], _dense_grads(q, k, v, bias, w, causal=True),
                  names="dq dk dv")


def test_length_zero_row_is_sk_times_dense_as_in_jax():
    """A row whose keys are all masked: s and lse both round to ~-1e9, so
    the fused backward rebuilds p = 1 per key instead of 1/Sk. The port
    holds to the JAX kernels there (a property of the reference)."""
    q, k, v, bias, w = _inputs(5, 2, 2, 2, 64, 64, 32, lengths=[40, 0])
    _, got = _port_grads(q, k, v, bias, w)
    jax_g = _jax_grads(q, k, v, bias, w)
    dense = _dense_grads(q, k, v, bias, w)
    _assert_grads(got, jax_g)
    for a, d in zip(got[:3], dense):
        np.testing.assert_allclose(a[0].numpy(), d[0], **TOL)          # real row
        np.testing.assert_allclose(a[1].numpy(), 64 * d[1], rtol=2e-4,
                                   atol=64 * 2e-4)                      # length 0


def test_bf16_gradient_dtypes_and_values():
    q, k, v, bias, w = _inputs(6, 2, 2, 2, 64, 64, 32, lengths=[64, 30])
    out, got = _port_grads(q, k, v, bias, w, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert [x.dtype for x in got] == [torch.bfloat16] * 3 + [torch.float32]
    want = _jax_grads(q, k, v, bias, w, dtype=jnp.bfloat16)
    # both sides round p, dS and the outputs to bf16, at different points
    # (einsum order, the JAX kernel's per-block partial sums): one or two
    # bf16 steps of the largest gradient entries
    for name, a, b in zip("dq dk dv dbias".split(), got, want):
        scale = np.abs(b).max()
        assert np.abs(a.float().numpy() - b).max() <= 2e-2 * scale, name


def test_reference_matches_fused_kernels_given_jax_lse():
    """flash_attention_backward_reference directly against
    `_flash_bwd_fused(..., interpret=True)`, both fed the JAX forward's own
    out and lse: non-causal with a length-0 row, and causal. (A causal row
    that sees no real key has no block-independent answer: the JAX kernels
    give p = 1 to the masked keys of the blocks they do not skip.)"""
    scale = 1 / math.sqrt(32)
    for causal, lengths in ((False, [64, 0]), (True, [64, 37])):
        q, k, v, bias, w = _inputs(7, 2, 2, 2, 64, 64, 32, lengths=lengths)
        jq, jk, jv, jb, jg = (jnp.asarray(a) for a in (q, k, v, bias, w))
        out, lse = _flash_call(jq, jk, jv, jb, causal, scale, 32, 32, True)
        want = _flash_bwd_fused(jq, jk, jv, jb, out, lse, jg, causal, scale,
                                32, 32, True)
        got = fa.flash_attention_backward_reference(
            *(torch.from_numpy(a) for a in (q, k, v, bias)),
            torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
            torch.from_numpy(w), causal=causal, scale=scale)
        _assert_grads(got, [np.asarray(x) for x in want])


def test_backward_wrapper_on_cpu_is_the_reference_and_does_not_count():
    q, k, v, bias, w = _inputs(8, 1, 2, 2, 32, 32, 32, lengths=[20])
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out, lse = fa.flash_attention_with_lse(*t)
    before = (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches)
    got = fa.flash_attention_backward(*t, out, lse, torch.from_numpy(w))
    want = fa.flash_attention_backward_reference(*t, out, lse, torch.from_numpy(w))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches) == before
    with pytest.raises(ValueError, match="NH == NKV"):
        fa.flash_attention_backward(t[0], t[1][:, :1], t[2][:, :1], t[3], out, lse,
                                    torch.from_numpy(w))


def test_function_only_under_autograd():
    q, k, v, bias, _ = _inputs(9, 1, 2, 2, 16, 16, 32, lengths=[16])
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    assert fa.flash_attention(*t).grad_fn is not None
    with torch.inference_mode():
        assert fa.flash_attention(*t).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(*t).grad_fn is None
    plain = [x.detach() for x in t]
    assert fa.flash_attention(*plain).grad_fn is None


def test_bias_gradient_only_when_asked():
    q, k, v, bias, w = _inputs(10, 1, 2, 2, 16, 16, 32, lengths=[9])
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    b = torch.from_numpy(bias)  # a padding mask: no gradient wanted
    (fa.flash_attention(*t, kv_bias=b) * torch.from_numpy(w)).sum().backward()
    assert b.grad is None and all(x.grad is not None for x in t)
    # the gradient reaches through transposed (non-contiguous) views, as
    # in bert.attention
    x = torch.from_numpy(q.transpose(0, 2, 1, 3).copy()).requires_grad_()
    heads = x.transpose(1, 2).contiguous()
    out = fa.flash_attention(heads, heads, heads, kv_bias=b)
    out.transpose(1, 2).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
