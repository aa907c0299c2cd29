"""The precision of the float32 forward kernel's products, rehearsed on the
CPU. B1 in float32 (`flash_fwd_f32_kernel`, `csrc/flash_attn_fwd.cu`) takes
both of its products, S = Q·Kᵀ and O += P·V, on the tensor cores in 3xTF32,
P split like the other operands. Here its tiled online softmax is rebuilt
(key tiles of the kernel's width, a running max and sum, the old sum and
output rescaled by alpha, exponents as 2^((x - m)·log2 e) with m and lse in
natural-log units) with both products on emulated TF32
(`tests/test_torch_flash_backward_f32.py`): with 3xTF32 it stays within
chip_smoke's float32 bar of the plain version and of the JAX kernel run in
interpret mode, and a length-0 row's lse is the plain version's bit for bit
(B2/B3 rebuild p = 1 there from it); with one TF32 product it falls
outside, which is why the kernel takes three."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from symbiont_tpu.ops.flash_attention import flash_attention as jax_flash
from symbiont_tpu_torch.ops import flash_attention as fa
from tests.test_torch_flash_backward_f32 import mm

BK = 64  # keys a tile at D = 64 (`FwdF32<64>::BK`)
ACC_NEG = -1e30  # the running max's start and the keys past Sk
LOG2E = 1.4426950408889634


def emulated_forward(q, k, v, bias, causal, scale, products):
    """B1's float32 forward, tile by tile over the keys, with both products
    on emulated TF32 tensor cores → (o, lse [B, NH, Sq, 1])."""
    Sq, Sk = q.shape[2], k.shape[2]
    m = torch.full((*q.shape[:3], 1), ACC_NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, Sk, BK):
        kt, vt = k[:, :, k0:k0 + BK], v[:, :, k0:k0 + BK]
        # product, then scale, then bias: the plain version's order
        s = mm(q, kt.transpose(-1, -2), products) * scale + bias[:, None, None, k0:k0 + BK]
        if causal:
            visible = torch.arange(Sq)[:, None] >= torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(visible, s, torch.full_like(s, fa.MASK_NEG))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * LOG2E)
        p = torch.exp2((s - mx) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt, products)
        m = mx
    return acc / l, m + torch.log(l)


def _case(seed, causal, lengths):
    """[2, 4, 128, 64] float32 from numpy with a seed: q/k/v and the padding
    bias of `lengths`."""
    B, NH, S, D = 2, 4, 128, 64
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, NH, S, D), dtype=np.float32))
               for _ in range(3))
    bias = torch.from_numpy(np.where(np.arange(S)[None, :] < np.asarray(lengths)[:, None],
                                     0.0, -1e9).astype(np.float32))
    return q, k, v, bias, causal, 1.0 / math.sqrt(D)


CASES = {"causal": (0, True, [128, 128]),
         # a padded row and a length-0 row (every key masked)
         "padded_len0": (1, False, [77, 0])}


def _lse_err(lse, ref):
    """chip_smoke's lse bar: |lse - plain| / (1 + |plain|)."""
    return float(((lse - ref).abs() / (1 + ref.abs())).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_forward_stays_within_the_float32_bar(case):
    q, k, v, bias, causal, scale = _case(*CASES[case])
    o, lse = emulated_forward(q, k, v, bias, causal, scale, products=3)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, bias, causal=causal)
    ok, err, worst = chip_smoke._within(o, ref, torch.float32)
    assert ok, f"{case}: max |3xTF32 - plain| {err:.3g}, {worst:.3g}x the bar"
    assert _lse_err(lse, ref_lse) <= 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tf32_product_falls_outside_the_float32_bar(case):
    q, k, v, bias, causal, scale = _case(*CASES[case])
    o, _ = emulated_forward(q, k, v, bias, causal, scale, products=1)
    ref, _ = fa.flash_attention_reference(q, k, v, bias, causal=causal)
    ok, _, worst = chip_smoke._within(o, ref, torch.float32)
    assert not ok, f"{case}: one TF32 product within the bar ({worst:.3g}x)"


def test_length0_row_lse_is_the_plain_versions_bit_for_bit():
    q, k, v, bias, causal, scale = _case(*CASES["padded_len0"])
    _, lse = emulated_forward(q, k, v, bias, causal, scale, products=3)
    _, ref_lse = fa.flash_attention_reference(q, k, v, bias, causal=causal)
    assert torch.equal(lse[1], ref_lse[1])
    assert (ref_lse[1] == fa.MASK_NEG).all()  # so B2/B3's s - lse is exactly 0 there


def test_3xtf32_forward_stays_within_the_bar_of_the_jax_kernel():
    q, k, v, bias, causal, scale = _case(*CASES["padded_len0"])
    o, _ = emulated_forward(q, k, v, bias, causal, scale, products=3)
    want = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                     kv_bias=jnp.asarray(bias.numpy()), causal=causal, block_q=32,
                     block_k=32, interpret=True)
    ok, err, worst = chip_smoke._within(o, torch.from_numpy(np.array(want)), torch.float32)
    assert ok, f"max |3xTF32 - JAX kernel| {err:.3g}, {worst:.3g}x the bar"
