"""The device-free parts of chip_smoke.py: the bounds it computes from
shapes, the bars it holds the backward kernels to, and its refusal to run
without a CUDA card (it must print no result there)."""

import chip_smoke
import pytest
import torch


def _meta(B, NH, S, D, dtype=torch.bfloat16):
    return torch.empty((B, NH, S, D), dtype=dtype, device="meta")


def test_backward_bounds_count_flops_and_bytes():
    q = _meta(32, 12, 512, 64)
    b = chip_smoke._bwd_bound_ms(q, q, causal=False)
    # 8 and 6 · B·NH·S²·D flops over 989 TFLOP/s bound both at S = 512
    assert b["kv"] == (pytest.approx(8 * 32 * 12 * 512 ** 2 * 64 / 989e12 * 1e3), "operations")
    assert b["q"] == (pytest.approx(6 * 32 * 12 * 512 ** 2 * 64 / 989e12 * 1e3), "operations")
    small = chip_smoke._bwd_bound_ms(_meta(32, 12, 64, 64), _meta(32, 12, 64, 64), False)
    ins = 4 * 32 * 12 * 64 * 64 * 2 + 32 * 64 * 4 + 2 * 32 * 12 * 64 * 4
    out_kv = 2 * 32 * 12 * 64 * 64 * 2 + 32 * 12 * 64 * 4
    assert small["kv"] == (pytest.approx((ins + out_kv) / 3.35e12 * 1e3), "bytes")
    assert small["q"][1] == "bytes"


def test_causal_backward_bound_counts_the_visible_half():
    q = _meta(2, 8, 1024, 64)
    full = chip_smoke._bwd_bound_ms(q, q, causal=False)["kv"][0]
    causal = chip_smoke._bwd_bound_ms(q, q, causal=True)["kv"][0]
    assert causal == pytest.approx(full * (1024 * 1025 / 2) / 1024 ** 2)


def test_backward_bars():
    # [batch 2, head 1, 3]: batch 0 stands for a length-0 row, whose
    # gradients are Sk x the dense ones; batch 1 for a real row
    ref = torch.tensor([[[10.0, -1.0, 0.5]], [[0.5, 0.1, -0.2]]])

    def bump(b, i, by):
        out = ref.clone()
        out[b, 0, i] += by
        return out

    ok, err, worst = chip_smoke._within(bump(0, 0, 0.19), ref, torch.bfloat16)
    assert ok and err == pytest.approx(0.19, abs=1e-6)  # bf16: 2e-2 of the slice's max
    assert worst == pytest.approx(0.95, rel=1e-5)
    assert not chip_smoke._within(bump(0, 2, 0.21), ref, torch.bfloat16)[0]
    # the length-0 slice sets no bar for the real one: 0.019 > 2e-2 · 0.5
    assert chip_smoke._within(bump(1, 1, 0.009), ref, torch.bfloat16)[0]
    assert not chip_smoke._within(bump(1, 1, 0.011), ref, torch.bfloat16)[0]
    assert chip_smoke._within(bump(0, 2, 1.4e-4), ref, torch.float32)[0]  # 1e-4 + 1e-4·|plain|
    assert not chip_smoke._within(bump(1, 2, 2e-4), ref, torch.float32)[0]


def test_refuses_without_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
