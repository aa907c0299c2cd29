"""The precision of the float32 backward kernels' products, rehearsed on
the CPU. B2 (dK/dV/dbias) and B3 (dQ) take every product on the tensor
cores in 3xTF32: each float32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi), and a product is lo·hi + hi·lo + hi·hi, accumulated in
float32 (`csrc/hopper.cuh`). Here TF32 rounding is emulated on the integer
view (round to nearest, ties away, at 10 mantissa bits: cvt.rna.tf32.f32)
and the kernels' math is rebuilt from it: with 3xTF32 it stays within
chip_smoke's float32 bar (|x - plain| ≤ 1e-4 + 1e-4·|plain|) of the plain
versions `bwd_kv_reference` / `bwd_q_reference`; with one TF32 product it
falls outside, which is why the kernels take three."""

import chip_smoke
import numpy as np
import pytest
import torch

from symbiont_tpu_torch.ops import flash_attention as fa


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, kept in float32: half a TF32 ulp added to the bits, the 13 bits
    below the TF32 mantissa cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b, products: int):
    """a @ b on emulated TF32 tensor cores: one product of the rounded
    operands, or 3xTF32 (lo·hi + hi·lo + hi·hi, the small terms first)."""
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulated_backward(q, k, v, bias, g, lse, delta, causal, scale, products):
    """B2's and B3's outputs with every product on emulated TF32 tensor
    cores and the elementwise steps in the kernels' float32 order
    (product, scale, bias, then less lse) → (dk, dv, per-head dbias, dq)."""
    s = mm(q, k.transpose(-1, -2), products) * scale + bias[:, None, None, :]
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        visible = torch.arange(Sq)[:, None] >= torch.arange(Sk)[None, :]
        s = torch.where(visible, s, torch.full_like(s, fa.MASK_NEG))
    p = torch.exp(s - lse)
    ds = p * (mm(g, v.transpose(-1, -2), products) - delta[..., None])
    dv = mm(p.transpose(-1, -2), g, products)
    dk = mm(ds.transpose(-1, -2), q, products) * scale
    dq = mm(ds, k, products) * scale
    return dk, dv, ds.sum(dim=2), dq


def _case(seed, causal, lengths):
    """[2, 4, 128, 64] float32 from numpy with a seed: q/k/v, the output
    cotangent g, the padding bias of `lengths`, and the forward's lse and δ
    from the plain forward."""
    B, NH, S, D = 2, 4, 128, 64
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, NH, S, D), dtype=np.float32))
                  for _ in range(4))
    bias = torch.from_numpy(np.where(np.arange(S)[None, :] < np.asarray(lengths)[:, None],
                                     0.0, -1e9).astype(np.float32))
    out, lse = fa.flash_attention_reference(q, k, v, bias, causal=causal)
    return (q, k, v, bias, g, lse, fa.bwd_delta(g, out), causal, 1.0 / np.sqrt(D))


CASES = {"causal": (0, True, [128, 128]),
         # a padded row and a length-0 row (every key masked: p = 1 for all)
         "padded_len0": (1, False, [77, 0])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_products_stay_within_the_float32_bar(case):
    args = _case(*CASES[case])
    dk, dv, dbias, dq = emulated_backward(*args, products=3)
    rdk, rdv, rdbias = fa.bwd_kv_reference(*args)
    rdq = fa.bwd_q_reference(*args)
    for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dbias", dbias, rdbias),
                           ("dq", dq, rdq)):
        ok, err, worst = chip_smoke._within(got, ref, torch.float32)
        assert ok, f"{case} {name}: max |3xTF32 - plain| {err:.3g}, {worst:.3g}x the bar"


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tf32_product_falls_outside_the_float32_bar(case):
    args = _case(*CASES[case])
    dk, dv, dbias, dq = emulated_backward(*args, products=1)
    rdk, rdv, rdbias = fa.bwd_kv_reference(*args)
    rdq = fa.bwd_q_reference(*args)
    for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq)):
        ok, err, worst = chip_smoke._within(got, ref, torch.float32)
        assert not ok, f"{case} {name}: one TF32 product within the bar ({worst:.3g}x)"


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's ulp at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23,
                      1.0 + 1.5 * ulp, 3.0])
    assert tf32(x).tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0]
    # hi + lo carries x to within 2^-22 of |x|
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(4096, dtype=np.float32))
    hi = tf32(y)
    assert ((y - (hi + tf32(y - hi))).abs() <= 2.0 ** -22 * y.abs()).all()
