"""The port's flash attention on the CPU (its plain PyTorch version) against
the JAX Pallas kernel run in interpret mode and the JAX dense reference, on
the same numpy inputs. The CUDA kernel itself is held against the same
plain version on the card by chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.ops.flash_attention import (
    _dense_reference,
    _flash_call,
    flash_attention as jax_flash,
)
from symbiont_tpu_torch.ops import _build
from symbiont_tpu_torch.ops import flash_attention as fa

F32_TOL = dict(rtol=2e-5, atol=2e-5)  # the bar of tests/test_ops_flash.py


def _inputs(seed, B, NH, NKV, Sq, Sk, D, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, NKV, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, NKV, Sk, D), dtype=np.float32)
    if lengths is None:
        lengths = rng.integers(1, Sk + 1, B)
    lengths = np.asarray(lengths)
    bias = np.where(np.arange(Sk)[None, :] < lengths[:, None], 0.0,
                    -1e9).astype(np.float32)
    return q, k, v, bias


def _port(q, k, v, bias, causal=False, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return fa.flash_attention_with_lse(*t, kv_bias=torch.from_numpy(bias),
                                       causal=causal)


def _jax(q, k, v, bias, causal=False):
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_bias=jnp.asarray(bias), causal=causal,
                                block_q=32, block_k=32, interpret=True))


def _dense(q, k, v, bias, causal=False):
    out, _ = _dense_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(bias), causal, 1 / math.sqrt(q.shape[-1]))
    return np.asarray(out)


def test_padding_bias_with_empty_row_matches_kernel_and_dense():
    # row 1 has length 0: every key masked, as for the engine's batch-padding
    # rows; the output must be finite (uniform attention), as on the TPU
    q, k, v, bias = _inputs(0, 2, 4, 4, 64, 64, 16, lengths=[41, 0])
    got, lse = _port(q, k, v, bias)
    got = got.numpy()
    assert np.isfinite(got).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(got, _jax(q, k, v, bias), **F32_TOL)
    np.testing.assert_allclose(got, _dense(q, k, v, bias), **F32_TOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(1, keepdims=True),
                                                       got[1].shape), **F32_TOL)


def test_causal_matches_kernel():
    q, k, v, bias = _inputs(1, 2, 4, 4, 64, 64, 16, lengths=[64, 64])
    got, _ = _port(q, k, v, bias, causal=True)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias, causal=True),
                               **F32_TOL)


def test_gqa_causal_padded_matches_kernel():
    # 8 q heads over 2 kv heads; lengths ≥ 1 so every causal row sees a key
    q, k, v, bias = _inputs(2, 2, 8, 2, 64, 64, 16, lengths=[64, 23])
    got, _ = _port(q, k, v, bias, causal=True)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias, causal=True),
                               **F32_TOL)


def test_sq_ne_sk_matches_kernel():
    q, k, v, bias = _inputs(3, 2, 4, 4, 32, 96, 16)
    got, _ = _port(q, k, v, bias)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_odd_length_matches_dense(causal):
    # no power-of-two block divides 37: the JAX path takes its dense fallback
    q, k, v, bias = _inputs(4, 2, 4, 4, 37, 37, 16, lengths=[37, 5])
    got, _ = _port(q, k, v, bias, causal=causal)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias, causal=causal),
                               **F32_TOL)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v, bias, causal=causal),
                               **F32_TOL)


def test_bf16_output_dtype_and_values():
    q, k, v, bias = _inputs(5, 2, 4, 4, 64, 64, 16, lengths=[64, 0])
    got, lse = _port(q, k, v, bias, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    b16 = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax_flash(*b16, kv_bias=jnp.asarray(bias), block_q=32, block_k=32,
                     interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0.05)


def test_lse_matches_kernel_lse():
    q, k, v, bias = _inputs(6, 2, 4, 4, 64, 64, 16, lengths=[50, 0])
    _, lse = _port(q, k, v, bias)
    _, want = _flash_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(bias), False, 1 / math.sqrt(16), 32, 32,
                          True)
    assert lse.shape == (2, 4, 64, 1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_no_bias_equals_zero_bias_and_cpu_path_does_not_count():
    q, k, v, _ = _inputs(7, 1, 2, 2, 16, 16, 8)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = fa.launches
    a = fa.flash_attention(*t)
    b = fa.flash_attention(*t, kv_bias=torch.zeros(1, 16))
    torch.testing.assert_close(a, b)
    assert fa.launches == before  # only kernel launches count


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 8, 16), (1, 3, 8, 16), (1, 3, 8, 16)), "multiple"),
    (((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)), "mismatch"),
    (((1, 2, 8, 16), (1, 2, 8, 8), (1, 2, 8, 8)), "disagree"),
])
def test_shape_errors(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


def test_bias_shape_and_device_errors():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="kv_bias"):
        fa.flash_attention(q, q, q, kv_bias=torch.zeros(1, 9))
    m = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(m, m, m)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_dir_keys_on_sources_and_flags(monkeypatch):
    a = _build.build_dir()
    assert a == _build.build_dir()
    assert a.parent == _build.BUILD_ROOT
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.build_dir() != a
