"""The device-free parts of chip_smoke.py: the bounds it computes from
shapes, the bars it holds the backward kernels to, the parameter and byte
counts and the checkpoint writers of its checkpoint, quantization and
generate phases, the generate phase's real-rows comparison, and its
refusal to run without a CUDA card (it must print no result there) or to
finish when a check fails."""

import dataclasses
import os
from pathlib import Path

import chip_smoke
import numpy as np
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
    # float32 at the 3xTF32 rate, 495 / 3 TFLOP/s: GPT-2's causal training
    # shape is bound by operations there, and lines name that rate
    f = _meta(8, 12, 1024, 64, torch.float32)
    b = chip_smoke._bwd_bound_ms(f, f, causal=True)
    pairs = 1024 * 1025 // 2
    assert b["kv"] == (pytest.approx(8 * 8 * 12 * pairs * 64 / 165e12 * 1e3), "operations")
    assert b["q"] == (pytest.approx(6 * 8 * 12 * pairs * 64 / 165e12 * 1e3), "operations")
    assert (round(b["kv"][0], 4), round(b["q"][0], 4)) == (0.1563, 0.1172)
    assert chip_smoke._bound_name(b["kv"][1], torch.float32) == "operations (3xTF32)"
    assert chip_smoke._bound_name("operations", torch.bfloat16) == "operations"
    assert chip_smoke._bound_name("bytes", torch.float32) == "bytes"
    f = _meta(8, 12, 64, 64, torch.float32)
    ins = 4 * 8 * 12 * 64 * 64 * 4 + 8 * 64 * 4 + 2 * 8 * 12 * 64 * 4
    assert chip_smoke._bwd_bound_ms(f, f, causal=True)["q"] == (
        pytest.approx((ins + 8 * 12 * 64 * 64 * 4) / 3.35e12 * 1e3), "bytes")


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


def test_refuses_without_cuda_with_memory_history(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--memory-history"]) != 0
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        chip_smoke.main(["--no-such-flag"])


# Short captured samples of the two reports chip_smoke.py reads on the card:
# `ptxas -v` from the kernels' build log, and `cuobjdump -sass` of the library.
_KV64 = ("_ZN50_GLOBAL__N__8cf49797_17_flash_attn_bwd_cu_644af25318bwd_kv_bf16_kernel"
         "ILi64EEEv14CUtensorMap_stS1_S1_S1_S1_S1_PKfP13__nv_bfloat16S5_Pfiiifi")
_Q64 = ("_ZN50_GLOBAL__N__8cf49797_17_flash_attn_bwd_cu_644af25317bwd_q_bf16_kernel"
        "ILi64EEEv14CUtensorMap_stS1_S1_S1_S1_PKfS3_P13__nv_bfloat16iiifi")
_F32 = ("_ZN50_GLOBAL__N__8cf49797_17_flash_attn_bwd_cu_644af25316bwd_q_f32_kernel"
        "ILi64EEEvPKfS3_S3_S3_S3_S3_S3_Pfiiifi")
_FWD64 = ("_ZN50_GLOBAL__N__1765d581_17_flash_attn_fwd_cu_326302ff21flash_fwd_bf16_kernel"
          "ILi64EEEv14CUtensorMap_stS1_S1_S1_P13__nv_bfloat16Pfiiiifi")
PTXAS = f"""\
ptxas info    : (C7519) warpgroup.arrive is injected in around line 13125 by compiler to allow use of registers in GMMA in function '{_KV64}'
ptxas info    : Compiling entry function '{_KV64}' for 'sm_90a'
ptxas info    : Function properties for {_KV64}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 164 registers, used 1 barriers
ptxas info    : Compiling entry function '{_Q64}' for 'sm_90a'
ptxas info    : Function properties for {_Q64}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '{_F32}' for 'sm_90a'
ptxas info    : Function properties for {_F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 18816 bytes smem
ptxas info    : Compiling entry function '{_FWD64}' for 'sm_90a'
ptxas info    : Function properties for {_FWD64}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 108 registers, used 1 barriers
ptxas info    : Compile time = 89.746 ms
"""
SASS = f"""\
	code for sm_90a
		Function : {_Q64}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a50*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0a60*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0a70*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
		Function : {_KV64}
        /*0b40*/                   HGMMA.64x32x16.F32.BF16 R88, gdesc[UR4], RZ, !UPT, gsb0 ;
		Function : {_F32}
        /*0000*/                   FFMA R3, R4, R5, R3 ;
		Function : {_FWD64}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*10b0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT ;
        /*12d0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], R24, gsb0 ;
        /*4690*/                   HGMMA.64x64x16.F32.BF16 R56, R92, gdesc[UR8].tnspB, R56 ;
        /*4790*/                   HGMMA.64x64x16.F32.BF16 R56, R24, gdesc[UR8].tnspB, R56, gsb0 ;
"""


def test_kernel_label_reads_the_mangled_name():
    assert chip_smoke.kernel_label(_KV64) == "bwd_kv_bf16_kernel<64>"
    assert chip_smoke.kernel_label(_Q64) == "bwd_q_bf16_kernel<64>"
    assert chip_smoke.kernel_label(_F32) == "bwd_q_f32_kernel<64>"
    assert chip_smoke.kernel_label("_Z3fooi") == "_Z3fooi"


def test_ptxas_report_reads_registers_and_spills():
    rep = chip_smoke.ptxas_report(PTXAS)
    assert rep["bwd_kv_bf16_kernel<64>"] == {"registers": 164, "spill_stores": 0,
                                             "spill_loads": 0}
    assert rep["bwd_q_bf16_kernel<64>"] == {"registers": 128, "spill_stores": 4,
                                            "spill_loads": 12}
    assert rep["bwd_q_f32_kernel<64>"]["registers"] == 64


def test_hgmma_counts_per_function():
    assert chip_smoke.hgmma_counts(SASS) == {"bwd_q_bf16_kernel<64>": 2,
                                             "bwd_kv_bf16_kernel<64>": 1,
                                             "bwd_q_f32_kernel<64>": 0,
                                             "flash_fwd_bf16_kernel<64>": 4}
    # HMMA (mma.sync) is counted apart from HGMMA
    sass = SASS.replace("FFMA R3, R4, R5, R3", "HMMA.1684.F32.TF32 R8, R12, R16, R8")
    assert chip_smoke.hgmma_counts(sass, "HMMA") == {"bwd_q_bf16_kernel<64>": 0,
                                                     "bwd_kv_bf16_kernel<64>": 0,
                                                     "bwd_q_f32_kernel<64>": 1,
                                                     "flash_fwd_bf16_kernel<64>": 0}


KERNELS = ("flash_fwd", "bwd_kv", "bwd_q")


def _instances(spill=0, hgmma=4, dims=(32, 64, 128), only=KERNELS):
    """Reports of every bf16 instance; those of the kernels in `only` get
    `spill`, `hgmma` and `dims`, the others a clean report at all dims."""
    ptxas, counts = {}, {}
    for k in KERNELS:
        bad = k in only
        for d in dims if bad else (32, 64, 128):
            name = f"{k}_bf16_kernel<{d}>"
            ptxas[name] = {"registers": 128, "spill_stores": spill if bad else 0,
                           "spill_loads": 0}
            counts[name] = hgmma if bad else 4
    ptxas["bwd_kv_f32_kernel<64>"] = {"registers": 64, "spill_stores": 8, "spill_loads": 8}
    ptxas["flash_fwd_f32_kernel<64>"] = {"registers": 80, "spill_stores": 8, "spill_loads": 8}
    return ptxas, counts


def test_backward_instances_pass_and_fail():
    rows = chip_smoke.wgmma_instances(*_instances())
    assert list(rows) == [f"{k}_bf16_kernel<{d}>" for k in KERNELS for d in (32, 64, 128)]
    assert rows["bwd_q_bf16_kernel<128>"]["hgmma"] == 4  # the f32 kernels' spills are not held
    bwd = ("bwd_kv", "bwd_q")
    with pytest.raises(RuntimeError, match="spills"):
        chip_smoke.wgmma_instances(*_instances(spill=4, only=bwd))
    with pytest.raises(RuntimeError, match="no HGMMA"):
        chip_smoke.wgmma_instances(*_instances(hgmma=0, only=bwd))
    with pytest.raises(RuntimeError, match="missing"):
        chip_smoke.wgmma_instances(*_instances(dims=(64, 128), only=bwd))
    # parsed from the captured samples: B3 at D = 64 spills there
    with pytest.raises(RuntimeError, match="bwd_q_bf16_kernel<64> spills"):
        ptxas = dict(_instances()[0], **chip_smoke.ptxas_report(PTXAS))
        chip_smoke.wgmma_instances(ptxas, dict(_instances()[1], **chip_smoke.hgmma_counts(SASS)))
    # the f32 instances are held by their own check: HMMA, no spills
    rows = chip_smoke.f32_instances(*_f32_instances())
    assert list(rows) == [f"{k}_f32_kernel<{d}>" for k in F32_KERNELS for d in (32, 64, 128)]
    assert rows["bwd_kv_f32_kernel<64>"] == {"registers": 192, "spill_stores": 0,
                                             "spill_loads": 0, "hmma": 96}
    with pytest.raises(RuntimeError, match=r"bwd_kv_f32_kernel<32> spills"):
        chip_smoke.f32_instances(*_f32_instances(spill=4))
    with pytest.raises(RuntimeError, match=r"bwd_kv_f32_kernel<32> has no HMMA"):
        chip_smoke.f32_instances(*_f32_instances(hmma=0))
    with pytest.raises(RuntimeError, match=r"missing: \[\('bwd_kv', '128'\)"):
        chip_smoke.f32_instances(*_f32_instances(dims=(32, 64)))
    # the spilling f32 B1 instance that `_instances` injects is held here
    ptxas, counts = _f32_instances()
    ptxas["flash_fwd_f32_kernel<64>"] = _instances()[0]["flash_fwd_f32_kernel<64>"]
    with pytest.raises(RuntimeError, match=r"flash_fwd_f32_kernel<64> spills"):
        chip_smoke.f32_instances(ptxas, counts)
    # the captured sample's scalar f32 instance: FFMA only, no HMMA
    ptxas, counts = _f32_instances()
    ptxas["bwd_q_f32_kernel<64>"] = dict(chip_smoke.ptxas_report(PTXAS)["bwd_q_f32_kernel<64>"],
                                         spill_stores=0, spill_loads=0)
    counts["bwd_q_f32_kernel<64>"] = chip_smoke.hgmma_counts(SASS, "HMMA")["bwd_q_f32_kernel<64>"]
    with pytest.raises(RuntimeError, match=r"bwd_q_f32_kernel<64> has no HMMA"):
        chip_smoke.f32_instances(ptxas, counts)


F32_KERNELS = ("flash_fwd", "bwd_kv", "bwd_q")


def _f32_instances(spill=0, hmma=96, dims=(32, 64, 128), only=("bwd_kv",)):
    """Reports of every f32 instance; those of the kernels in `only` get
    `spill`, `hmma` and `dims`, the others a clean report at all dims."""
    ptxas, counts = {}, {}
    for k in F32_KERNELS:
        bad = k in only
        for d in dims if bad else (32, 64, 128):
            name = f"{k}_f32_kernel<{d}>"
            ptxas[name] = {"registers": 192, "spill_stores": spill if bad else 0,
                           "spill_loads": 0}
            counts[name] = hmma if bad else 96
    return ptxas, counts


@pytest.mark.parametrize("fault, match", [
    (dict(spill=4), r"flash_fwd_f32_kernel<32> spills"),
    (dict(hmma=0), r"flash_fwd_f32_kernel<32> has no HMMA"),
    (dict(dims=(32, 64)), r"missing: \[\('flash_fwd', '128'\)\]"),
    # the captured sample's scalar f32 instance (FFMA only, no HMMA) standing
    # in for B1's: the scalar kernel the 3xTF32 one replaced fails as it did
    ("scalar", r"flash_fwd_f32_kernel<64> has no HMMA"),
])
def test_f32_forward_instances_fail(fault, match):
    if fault == "scalar":
        ptxas, counts = _f32_instances()
        ptxas["flash_fwd_f32_kernel<64>"] = dict(
            chip_smoke.ptxas_report(PTXAS)["bwd_q_f32_kernel<64>"], spill_stores=0,
            spill_loads=0)
        counts["flash_fwd_f32_kernel<64>"] = chip_smoke.hgmma_counts(SASS, "HMMA")[
            "bwd_q_f32_kernel<64>"]
    else:
        ptxas, counts = _f32_instances(only=("flash_fwd",), **fault)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.f32_instances(ptxas, counts)


def test_forward_instance_read_from_the_captured_samples():
    assert chip_smoke.kernel_label(_FWD64) == "flash_fwd_bf16_kernel<64>"
    assert chip_smoke.ptxas_report(PTXAS)["flash_fwd_bf16_kernel<64>"] == {
        "registers": 108, "spill_stores": 0, "spill_loads": 0}
    # the sample's B1 instance passes where it stands in for the clean one
    ptxas, counts = _instances()
    rep, hg = chip_smoke.ptxas_report(PTXAS), chip_smoke.hgmma_counts(SASS)
    ptxas["flash_fwd_bf16_kernel<64>"] = rep["flash_fwd_bf16_kernel<64>"]
    counts["flash_fwd_bf16_kernel<64>"] = hg["flash_fwd_bf16_kernel<64>"]
    rows = chip_smoke.wgmma_instances(ptxas, counts)
    assert rows["flash_fwd_bf16_kernel<64>"] == {"registers": 108, "spill_stores": 0,
                                                 "spill_loads": 0, "hgmma": 4}


@pytest.mark.parametrize("fault, match", [
    (dict(dims=(32, 128)), r"missing: \[\('flash_fwd', '64'\)\]"),
    (dict(spill=16), r"flash_fwd_bf16_kernel<32> spills"),
    (dict(hgmma=0), r"flash_fwd_bf16_kernel<32> has no HGMMA"),
])
def test_forward_instances_fail(fault, match):
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.wgmma_instances(*_instances(only=("flash_fwd",), **fault))


def test_forward_instance_without_hgmma_in_sass_fails():
    # a B1 instance the SASS lists with no HGMMA (the mma.sync design)
    ptxas, counts = _instances()
    sass = SASS.replace("HGMMA", "HMMA")
    counts["flash_fwd_bf16_kernel<64>"] = chip_smoke.hgmma_counts(sass)["flash_fwd_bf16_kernel<64>"]
    with pytest.raises(RuntimeError, match="flash_fwd_bf16_kernel<64> has no HGMMA"):
        chip_smoke.wgmma_instances(ptxas, counts)


def test_cuobjdump_lookup(monkeypatch, tmp_path):
    import importlib.machinery

    from symbiont_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        _build.cuobjdump()
    # Triton's copy is taken when nvcc has none beside it
    tool = tmp_path / "triton" / "backends" / "nvidia" / "bin" / "cuobjdump"
    tool.parent.mkdir(parents=True)
    tool.write_text("")
    spec = importlib.machinery.ModuleSpec("triton", None, is_package=True)
    spec.submodule_search_locations = [str(tmp_path / "triton")]
    monkeypatch.setattr(_build.importlib.util, "find_spec", lambda name: spec)
    assert _build.cuobjdump() == str(tool)
    # the toolkit's own, beside nvcc, comes first
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "cuobjdump").write_text("")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "bin" / "nvcc"))
    assert _build.cuobjdump() == str(tmp_path / "bin" / "cuobjdump")


# The checkpoint and quantization phases' arithmetic and writer.

TINY_XLMR = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=34, type_vocab_size=1,
                 layer_norm_eps=1e-5, position_offset=2)


def _leaf_counts(tree):
    from symbiont_tpu_torch.models import quant

    leaves = list(quant.leaves(tree))
    return {"matrix": sum(t.numel() for t in leaves if t.ndim >= 2),
            "scales": sum(t.shape[-1] for t in leaves if t.ndim >= 2),
            "vector": sum(t.numel() for t in leaves if t.ndim < 2)}


@pytest.mark.parametrize("with_pooler", [False, True])
@pytest.mark.parametrize("geom", [TINY_XLMR, chip_smoke.MINILM_L6], ids=["xlmr", "minilm"])
def test_param_counts_match_the_initialised_tree(geom, with_pooler):
    from symbiont_tpu_torch.models import bert as bert_mod

    cfg = bert_mod.BertConfig(**geom)
    tree = bert_mod.init_params(torch.Generator().manual_seed(0), cfg, with_pooler=with_pooler)
    want = _leaf_counts(tree)
    got = chip_smoke.param_counts(geom, with_pooler=with_pooler)
    assert {k: got[k] for k in want} == want
    assert got["total"] == want["matrix"] + want["vector"]


def test_mpnet_multilingual_geometry_bytes():
    n = chip_smoke.param_counts(chip_smoke.MPNET_MULTILINGUAL)
    assert n["total"] == 277_453_056  # paraphrase-multilingual-mpnet-base-v2
    none = chip_smoke.expected_param_bytes(chip_smoke.MPNET_MULTILINGUAL, "none")
    int8 = chip_smoke.expected_param_bytes(chip_smoke.MPNET_MULTILINGUAL, "int8")
    assert none == 2 * n["total"] == 554_906_112
    assert int8 == chip_smoke.expected_param_bytes(chip_smoke.MPNET_MULTILINGUAL, "fp8")
    assert int8 == n["matrix"] + 4 * n["scales"] + 2 * n["vector"] == 277_915_392
    assert int8 / none < 0.55


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["none", "f16", "int8", "fp8"])
def test_expected_param_bytes_is_what_the_engine_holds(mode, dtype):
    from symbiont_tpu_torch.config import EngineConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.models import bert as bert_mod
    from symbiont_tpu_torch.models import quant

    cfg = bert_mod.BertConfig(**TINY_XLMR)
    params = bert_mod.init_params(torch.Generator().manual_seed(1), cfg)
    eng = TorchEngine(EngineConfig(embedding_dim=32, dtype=dtype, quantize=mode),
                      params=params, model_cfg=cfg, device="cpu")
    assert quant.param_bytes(eng.params) == chip_smoke.expected_param_bytes(TINY_XLMR, mode, dtype)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_write_checkpoint_reads_back(tmp_path, fmt):
    from symbiont_tpu_torch.models import bert as bert_mod
    from symbiont_tpu_torch.models.convert import load_bert_model

    cfg = bert_mod.BertConfig(**TINY_XLMR)
    params = bert_mod.init_params(torch.Generator().manual_seed(2), cfg, with_pooler=True)
    hf = chip_smoke.write_checkpoint(tmp_path, params, cfg, fmt)
    # config.json inverts BertConfig.from_hf: XLM-R, pad id 1, one token type
    assert (hf["model_type"], hf["pad_token_id"], hf["type_vocab_size"]) == ("xlm-roberta", 1, 1)
    assert (hf["vocab_size"], hf["num_hidden_layers"], hf["layer_norm_eps"]) == (300, 2, 1e-5)
    name = {"safetensors": "model.safetensors", "bin": "pytorch_model.bin"}[fmt]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["config.json", name]
    if fmt == "bin":
        sd = torch.load(tmp_path / name, weights_only=True)
        assert "bert.embeddings.word_embeddings.weight" in sd and "classifier.weight" in sd
    back, back_cfg = load_bert_model(tmp_path, with_pooler=True)
    assert back_cfg == cfg
    assert np.array_equal(back["layers"][1]["mlp"]["in"]["kernel"],
                          params["layers"][1]["mlp"]["in"]["kernel"].numpy())
    assert np.array_equal(back["classifier"]["kernel"], params["classifier"]["kernel"].numpy())
    with pytest.raises(ValueError, match="format"):
        chip_smoke.write_checkpoint(tmp_path / "x", params, cfg, "npz")


# Frames as torch's memory history records them (innermost first).
_ROOT = "/work/repo"
_FRAMES = [
    {"filename": "/usr/lib/python3/site-packages/torch/nn/functional.py", "line": 10,
     "name": "linear"},
    {"filename": f"{_ROOT}/symbiont_tpu_torch/train/trainer.py", "line": 120, "name": "loss"},
    {"filename": f"{_ROOT}/symbiont_tpu_torch/train/trainer.py", "line": 200, "name": "step"},
    {"filename": f"{_ROOT}/chip_smoke.py", "line": 700, "name": "train_path"},
]


def test_alloc_site_names_the_innermost_repo_frames():
    assert chip_smoke.alloc_site(_FRAMES, _ROOT) == (
        "symbiont_tpu_torch/train/trainer.py:120 loss < symbiont_tpu_torch/train/trainer.py:200 step")
    assert chip_smoke.alloc_site(_FRAMES[:1], _ROOT) is None
    assert chip_smoke.alloc_site([], _ROOT) is None


def test_group_blocks_by_site_pool_and_reachability():
    segments = [
        {"segment_pool_id": (0, 0), "blocks": [
            {"address": 100, "size": 4096, "state": "active_allocated", "frames": _FRAMES},
            {"address": 200, "size": 2048, "state": "active_allocated", "frames": _FRAMES},
            {"address": 300, "size": 1 << 20, "state": "inactive"},
            {"address": 400, "size": 512, "state": "active_allocated"}]},
        {"segment_pool_id": (1, 7), "blocks": [
            {"address": 500, "size": 8192, "state": "active_allocated", "frames": []}]},
    ]
    groups = chip_smoke.group_blocks(segments, reachable={200}, root=_ROOT)
    site = chip_smoke.alloc_site(_FRAMES, _ROOT)
    assert groups == [
        (8192, 1, "pool (1, 7), no history, block of 8,192", False),
        (4096, 1, site, False),
        (2048, 1, site, True),
        (512, 1, "pool (0, 0), no history, block of 512", False),
    ]
    assert sum(g[0] for g in groups) == 8192 + 4096 + 2048 + 512  # inactive blocks left out


def test_top_kernels_keeps_device_entries_by_self_time():
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = [SimpleNamespace(key=k, self_device_time_total=us, count=c, device_type=d)
          for k, us, c, d in [("aten::mm", 9e6, 1, DeviceType.CPU),
                              ("gemm", 3000.0, 72, DeviceType.CUDA),
                              ("mul", 1500.0, 144, DeviceType.CUDA),
                              ("copy", 4500.0, 10, DeviceType.CUDA)]]
    assert chip_smoke.top_kernels(ev, 2) == [("copy", 4.5, 10), ("gemm", 3.0, 72)]
    # the fields it reads exist on a real profile's entries (none on the card here)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) @ torch.ones(8)
    events = prof.key_averages()
    assert chip_smoke.top_kernels(events) == []
    assert all(e.self_device_time_total == 0 and e.count >= 1 and e.key for e in events)


def test_storage_bytes_counts_each_storage_once():
    from symbiont_tpu_torch.models import quant

    w = torch.ones(4, 6)
    qt = quant.quantize_params({"k": torch.randn(5, 3)}, "int8")["k"]
    got = chip_smoke._storage_bytes({"a": w, "b": [w, qt]}, {"c": torch.zeros(3)})
    assert sorted(got.values()) == sorted([4 * 6 * 4, 5 * 3, 3 * 4, 3 * 4])
    assert got[w.untyped_storage().data_ptr()] == 96


def test_kernel_short_keeps_the_functor_in_view():
    mixed = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<"
             "at::native::BinaryFunctor<c10::BFloat16, float, float, "
             "at::native::binary_internal::MulFunctor<float> > >(at::TensorIteratorBase&, "
             "at::native::BinaryFunctor<c10::BFloat16, float, float, "
             "at::native::binary_internal::MulFunctor<float> > const&)::{lambda(int)#1}>"
             "(int, {lambda(int)#1})")
    assert chip_smoke.kernel_short(mixed) == (
        "elementwise_kernel<128, 4, gpu_kernel_impl<BinaryFunctor<BFloat16, float, float, "
        "MulFunctor<float> > >")
    copy = ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda"
            "(at::TensorIteratorBase&)::{lambda()#1}::operator()() const::{lambda(float)#1}, "
            "std::array<char*, 2ul> >(int, ...)")
    assert chip_smoke.kernel_short(copy) == "vectorized_elementwise_kernel<8, bfloat16_copy_kernel_cuda"
    assert chip_smoke.kernel_short("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN") == (
        "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN")
    assert len(chip_smoke.kernel_short("k<" + "a" * 500 + ">", width=40)) == 40


def test_clear_cublas_workspaces_without_the_call_frees_nothing(monkeypatch):
    monkeypatch.delattr(torch._C, "_cuda_clearCublasWorkspaces", raising=False)
    assert chip_smoke.clear_cublas_workspaces() == 0


# ---------------------------------------------------------------- generate

TINY_LLAMA = dict(chip_smoke.TINYLLAMA_1B, vocab_size=300, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, intermediate_size=48,
                  max_position_embeddings=64)
TINY_GPT2 = dict(chip_smoke.GPT2_124M, vocab_size=300, n_embd=32, n_layer=2, n_head=4,
                 n_positions=64)


def test_decoder_geometries_have_their_published_sizes():
    assert chip_smoke.gpt_param_count(chip_smoke.TINYLLAMA_1B) == 1_100_048_384
    assert chip_smoke.gpt_param_count(chip_smoke.GPT2_124M) == 124_439_808
    # bf16 at rest: the bytes [generate] holds param_bytes to
    assert 2 * chip_smoke.gpt_param_count(chip_smoke.TINYLLAMA_1B) == 2_200_096_768


@pytest.mark.parametrize("hf", [TINY_LLAMA, TINY_GPT2, dict(TINY_LLAMA, tie_word_embeddings=True)],
                         ids=["llama", "gpt2", "llama-tied"])
def test_gpt_param_count_matches_the_initialised_tree(hf):
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.models import quant

    params = gpt_mod.init_params(torch.Generator().manual_seed(0), gpt_mod.GPTConfig.from_hf(hf))
    assert chip_smoke.gpt_param_count(hf) == sum(t.numel() for t in quant.leaves(params))


def _flat(tree, path=()):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("hf", [TINY_LLAMA, TINY_GPT2], ids=["llama", "gpt2"])
def test_gpt_checkpoint_is_the_hubs_layout(hf, tmp_path):
    """The written dir converts back to the same tree (float32 bit for bit;
    bf16 as its rounding), and its state dict loads into the `transformers`
    model of the same config, whose logits are the port's."""
    transformers = pytest.importorskip("transformers")
    from symbiont_tpu_torch.models import convert
    from symbiont_tpu_torch.models import gpt as gpt_mod

    cfg = dataclasses.replace(gpt_mod.GPTConfig.from_hf(hf), dtype="float32")
    params = gpt_mod.init_params(torch.Generator().manual_seed(3), cfg)
    for dtype in (torch.float32, torch.bfloat16):
        chip_smoke.write_gpt_checkpoint(tmp_path / str(dtype), params, hf, dtype)
        back, back_cfg = convert.load_gpt_model(tmp_path / str(dtype))
        assert back_cfg == dataclasses.replace(cfg, dtype="bfloat16")
        got, want = _flat(back), _flat(params)
        assert sorted(got) == sorted(want)
        for path, leaf in want.items():
            assert np.array_equal(got[path], leaf.to(dtype).float().numpy()), path
    auto = {"llama": transformers.LlamaForCausalLM, "gpt2": transformers.GPT2LMHeadModel}
    model = auto[hf["model_type"]](transformers.AutoConfig.for_model(**hf)).eval()
    sd = {k: torch.from_numpy(v) for k, v in chip_smoke.gpt_state_dict(
        params, cfg, torch.float32).items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == [] and set(missing) <= {"lm_head.weight"}  # GPT-2 ties it
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 300, (2, 10)))
    with torch.no_grad():
        want = model(ids).logits.numpy()
    cache = gpt_mod.init_cache(cfg, 2, 10, torch.float32)
    got, _ = gpt_mod.forward(params, ids, cache, torch.arange(10).expand(2, 10), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


def test_causal_gqa_bound_counts_the_visible_half_and_kv_heads():
    def meta(B, NH, S):
        return torch.empty((B, NH, S, 64), dtype=torch.bfloat16, device="meta")

    bias = torch.empty((8, 1024), device="meta")
    ms, by = chip_smoke._bound_ms(meta(8, 32, 1024), meta(8, 4, 1024), meta(8, 4, 1024), bias,
                                  causal=True)
    # 4·B·NH·D flops per visible (q, k) pair, S(S+1)/2 pairs: 2·B·NH·S(S+1)·D
    assert (ms, by) == (pytest.approx(2 * 8 * 32 * 1024 * 1025 * 64 / 989e12 * 1e3), "operations")
    assert ms == pytest.approx(0.0348, abs=1e-4)
    ms, by = chip_smoke._bound_ms(meta(8, 32, 256), meta(8, 4, 256), meta(8, 4, 256),
                                  torch.empty((8, 256), device="meta"), causal=True)
    # q and o at 32 heads, k and v at 4, bias and lse in float32
    nbytes = 2 * 8 * 32 * 256 * 64 * 2 + 2 * 8 * 4 * 256 * 64 * 2 + 8 * 256 * 4 + 8 * 32 * 256 * 4
    assert (ms, by) == (pytest.approx(nbytes / 3.35e12 * 1e3), "bytes")
    # float32 counts its flops at the 3xTF32 rate (495 / 3 TFLOP/s)
    f32 = [torch.empty((8, nh, 1024, 64), device="meta") for nh in (32, 4, 4)]
    ms, by = chip_smoke._bound_ms(*f32, bias, causal=True)
    assert (ms, by) == (pytest.approx(2 * 8 * 32 * 1024 * 1025 * 64 / 165e12 * 1e3), "operations")


def test_real_rows_comparison_skips_padding_queries():
    lens = [4, 1]
    bias = chip_smoke.left_pad_bias(lens, 4, device="cpu")
    assert bias.tolist() == [[0.0] * 4, [-1e9, -1e9, -1e9, 0.0]]
    real = chip_smoke.real_query_rows(lens, 4, device="cpu")
    assert real.shape == (2, 1, 4, 1)
    assert real[:, 0, :, 0].tolist() == [[True] * 4, [False, False, False, True]]
    ref = torch.ones((2, 3, 4, 8))
    out = ref.clone()
    out[1, :, :3] = 50.0  # padding queries: any value passes
    ok, err = chip_smoke.real_rows_within(out, ref, real, 2e-2)
    assert ok and err == 0.0
    out[1, 2, 3, 5] += 0.05  # a real row past 0.02 + 0.02·1
    ok, err = chip_smoke.real_rows_within(out, ref, real, 2e-2)
    assert not ok and err == pytest.approx(0.05)
    out[1, 2, 3, 5] = 1.03
    assert chip_smoke.real_rows_within(out, ref, real, 2e-2)[0]


def test_ragged_prompts_fill_their_bucket():
    from symbiont_tpu_torch.engine.lm import ByteTokenizer

    tok = ByteTokenizer()
    prompts = chip_smoke.ragged_prompts(np.random.default_rng(0), 64, 256, 8)
    lens = [len(tok.encode(p, 1 << 30)) for p in prompts]
    assert len(prompts) == 8 and all(64 < n <= 256 for n in lens) and lens[-1] == 256


def test_next_token_cosines():
    a = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 9.0]])
    got = chip_smoke.next_token_cosines(a, a.clone())
    assert got == pytest.approx([1.0, 1.0])
    b = torch.tensor([[3.0, 2.0, 1.0], [0.0, 0.0, 9.0]])
    got = chip_smoke.next_token_cosines(a, b)
    assert got[0] < 0.6 and got[1] == pytest.approx(1.0)


def test_a_failing_generate_check_fails_the_run(monkeypatch, capsys):
    """Every phase before [generate] stubbed to pass; a check failing in
    [generate] leaves main() by its exception (the script exits non-zero)
    and prints no result."""
    from pathlib import Path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: chip_smoke.check(False, "B1 launches 21 != 22"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="B1 launches 21 != 22"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


# ----------------------------------------------------------------- session

TINY_SESSION = dict(stream_bucket=(16, 32), new=16, chunk=4, session_bucket=(8, 16),
                    gpt2_bucket=(8, 16), batcher_bucket=(8, 16),
                    first_wave=(6, 8, 10, 12, 14, 16, 16, 16),
                    later_waves=(4, 4, 4, 4, 16, 12, 8, 4))


def _rehearse_session(tmp_path, monkeypatch) -> dict:
    """`session_phase` on the CPU at tiny geometries from checkpoints
    written here; the CPU path launches no kernel, so the plain forwards of
    B1 are counted as its launches."""
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.ops import flash_attention as fa

    for name, hf, dtype in (("tinyllama", TINY_LLAMA, torch.bfloat16),
                            ("gpt2", TINY_GPT2, torch.float32)):
        params = gpt_mod.init_params(torch.Generator().manual_seed(len(name)),
                                     gpt_mod.GPTConfig.from_hf(hf))
        chip_smoke.write_gpt_checkpoint(tmp_path / name, params, hf, dtype)
    forward = fa._forward

    def counted(*a, **kw):
        fa.launches += 1
        return forward(*a, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    return chip_smoke.session_phase(
        np.random.default_rng(0), tmp_path, sizes=TINY_SESSION, device="cpu",
        lm_kw=dict(force_cpu=True, prompt_buckets=[8, 16, 32], new_token_buckets=[4, 16]))


def test_session_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """[session] end to end on the CPU at tiny geometries, with every check
    it makes on the card."""
    out = _rehearse_session(tmp_path, monkeypatch)
    printed = capsys.readouterr().out
    # B1 against plain at 3 TinyLlama shapes, 4 batcher row counts and 2
    # GPT-2 shapes; the stream, batcher, session, bytes, profiler and GPT-2
    assert printed.count("[session] flash_attn_fwd causal") == 9
    assert printed.count("[session]") == 15
    assert out["admit_bytes"]["forecast_1_row"] > 0 and out["admit_bytes"]["headroom"] is None
    assert out["batcher"]["admitted_midflight"] > 0 and out["batcher"]["sessions"] >= 2
    assert out["batcher"]["tok_s"] > 0 and out["session_busy_pct"] is None
    assert out["stream"]["last_delta_ms"] >= out["stream"]["first_delta_ms"] > 0
    # 2 layers: generate() and the stream, the batcher's prefills, a session
    # start and its admission, the profiled session; GPT-2's start and
    # admission
    assert out["launches"] % 2 == 0 and out["launches"] >= 2 * (1 + 2 + 2 + 1) + 2 * 2


def test_session_batcher_admits_with_a_slow_cold_admission_prefill(tmp_path, monkeypatch):
    """The `GenBatcher` check of [session] with every cold admission
    prefill slowed by 0.2 s, tens of CPU decode chunks, as a capture and
    its cost analysis are slow on the card against a chunk: newcomers still
    join a running session, since each later wave is sent after a decode
    chunk and the admission shapes are warmed before the pass. With waves
    on a fixed clock and no warm-up, this slowing leaves none admitted."""
    import time

    from symbiont_tpu_torch.engine.lm import BatchSession

    prepare = BatchSession.prepare_admit

    def slowed(self, prompts, *a, **kw):
        if not self.prefill_warm(len(prompts)):
            time.sleep(0.2)
        return prepare(self, prompts, *a, **kw)

    monkeypatch.setattr(BatchSession, "prepare_admit", slowed)
    out = _rehearse_session(tmp_path, monkeypatch)
    assert out["batcher"]["admitted_midflight"] > 0 and out["batcher"]["sessions"] >= 2


def test_a_failing_session_check_fails_the_run(monkeypatch, capsys):
    """Every phase before [session] stubbed to pass; a check failing in
    [session] leaves main() by its exception and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: {"launches": 0},
                 session_phase=lambda rng, tmp: chip_smoke.check(False, "admitted_midflight 0"),
                 stack_phase=lambda rng, tmp, serve: {"launches": 0})
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="admitted_midflight 0"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


# ------------------------------------------------------------ paged, spec

TINY_PAGED = dict(TINY_SESSION, bucket=(8, 16), new=16, prefix=8, page=4, spec_k=4,
                  verify_rows=2, verify_cache=32, twin_new=8,
                  drafter=dict(chip_smoke.LLAMA_68M, vocab_size=300, hidden_size=16,
                               num_hidden_layers=1, num_attention_heads=2,
                               num_key_value_heads=2, intermediate_size=24,
                               max_position_embeddings=64))
TINY_LM_KW = dict(force_cpu=True, prompt_buckets=[8, 16, 32], new_token_buckets=[4, 16, 32])


@pytest.fixture
def tiny_dirs(tmp_path, monkeypatch):
    """The tiny TinyLlama and GPT-2 dirs, the llama's params as [session]
    hands them on, and B1's plain forwards counted as its launches (the CPU
    path launches no kernel)."""
    from symbiont_tpu_torch.config import LmConfig
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.ops import flash_attention as fa

    for name, hf, dtype in (("tinyllama", TINY_LLAMA, torch.bfloat16),
                            ("gpt2", TINY_GPT2, torch.float32)):
        params = gpt_mod.init_params(torch.Generator().manual_seed(len(name)),
                                     gpt_mod.GPTConfig.from_hf(hf))
        chip_smoke.write_gpt_checkpoint(tmp_path / name, params, hf, dtype)
    forward = fa._forward

    def counted(*a, **kw):
        fa.launches += 1
        return forward(*a, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    eng = LmEngine(LmConfig(model_dir=str(tmp_path / "tinyllama"), attn_impl="flash",
                            **TINY_LM_KW))
    return tmp_path, (eng.params, eng.model_cfg)


def test_paged_phase_rehearses_on_the_cpu(tiny_dirs, capsys):
    """[paged] end to end on the CPU at tiny geometries (pages of 4 tokens),
    with every check it makes on the card."""
    tmp, tinyllama = tiny_dirs
    out = chip_smoke.paged_phase(np.random.default_rng(0), tmp, tinyllama,
                                 dense_batcher={"tok_s": 1.0}, sizes=TINY_PAGED, device="cpu",
                                 lm_kw=TINY_LM_KW)
    printed = capsys.readouterr().out
    assert printed.count("[paged]") == 5
    # 8 rows x (32 + 32) slots / 4-token pages x 2 + scratch; 2 layers x k, v
    # x 2 KV heads x 8 x bf16 a token
    assert out["pool_pages"] == 2 * 8 * 16 + 1 and out["pool_bytes"] == 257 * 4 * 2 * 2 * 2 * 8 * 2
    assert 0 < out["peak_pages"] and out["peak_bytes"] < 8 * out["dense_slab_bytes"]
    assert out["batcher"]["admitted_midflight"] > 0 and out["batcher"]["tok_s"] > 0
    assert out["batcher"]["decode_kv_stranded_pct"] == 0.0  # paged rows hold pages
    # 2 layers: dense and paged starts and admissions, the partial hit, the
    # batcher's prefills, GPT-2's four sessions with an admission each
    assert out["launches"] % 2 == 0 and out["launches"] >= 2 * (4 + 1 + 2) + 2 * 8


def test_spec_phase_rehearses_on_the_cpu(tiny_dirs, capsys):
    """[spec] end to end on the CPU at tiny geometries: the self-drafted,
    corrupted and small-drafter sessions, the round executables stepped
    beside their eager twins, and the verify check."""
    tmp, tinyllama = tiny_dirs
    out = chip_smoke.spec_phase(np.random.default_rng(0), tmp, tinyllama, sizes=TINY_PAGED,
                                device="cpu", lm_kw=TINY_LM_KW)
    printed = capsys.readouterr().out
    assert printed.count("[spec] flash_attn_fwd causal") == 3  # B1 at its new shapes
    assert printed.count("[spec]") == 8
    twins = out["twins"]
    assert len(twins) == 4 and all(t["rounds"] > 0 for t in twins.values())
    assert all({"spec_first", "draft", "verify"} <= set(t["capture_ms"]) for t in twins.values())
    assert all(r["acceptance"] == 1.0 and r["tokens_per_round"] == 5.0
               for r in out["self_drafted"].values())
    assert out["corrupted_acceptance"] == 2 / 4
    assert set(out["llama_68m"]) == {"float32", "bfloat16"}
    assert out["verify"]["cosine_min"] >= chip_smoke.GEN_COS_BAR
    # 2 layers, a 1-layer drafter: the stream and two self-drafted sessions
    # (2 + 2 each), the corrupted one (2 + 2), the small drafter's two (2 + 1)
    assert out["launches"] == 4 * 4 + 2 * 3


def test_a_failing_spec_check_fails_the_run(monkeypatch, capsys):
    """Every phase before [spec] stubbed to pass; a spec phase proposing no
    drafts leaves main() by its exception and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: {"launches": 0},
                 session_phase=lambda rng, tmp: {"launches": 0, "batcher": {},
                                                 "tinyllama": None},
                 paged_phase=lambda rng, tmp, tl, dense_batcher: {"launches": 0},
                 spec_phase=lambda rng, tmp, tl: chip_smoke.check(
                     False, "self-drafted stream: 0 draft tokens proposed"),
                 stack_phase=lambda rng, tmp, serve: {"launches": 0})
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="0 draft tokens proposed"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


# ----------------------------------------------------------------- lmtrain

TINY_LMTRAIN = dict(seq_len=8, batch=2, lr=5e-3, batches=3, passes=3, long_seq=32, gen_new=8, pages=2,
                    sentences=4, min_chars=64, timeout_s=120.0)


def _count_cpu_launches(monkeypatch):
    """The CPU path launches no kernel: count B1's plain forwards and the
    plain fused backward (B2 and B3) as launches, from 0."""
    from symbiont_tpu_torch.ops import flash_attention as fa

    chip_smoke.count_plain_launches(fa, monkeypatch.setattr)
    for name in ("launches", "bwd_kv_launches", "bwd_q_launches"):  # restored after
        monkeypatch.setattr(fa, name, 0)


def test_lmtrain_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """[lmtrain] end to end on the CPU at the tiny GPT-2 (2 layers), with
    every check it makes on the card but the kernel rows: the CPU path
    launches no kernel, so B1's plain forwards and the plain backward are
    counted as the launches, and nothing captures (every step counts once
    per layer)."""
    from symbiont_tpu_torch.models import gpt as gpt_mod

    params = gpt_mod.init_params(torch.Generator().manual_seed(4),
                                 gpt_mod.GPTConfig.from_hf(TINY_GPT2))
    chip_smoke.write_gpt_checkpoint(tmp_path / "gpt2", params, TINY_GPT2, torch.float32)
    _count_cpu_launches(monkeypatch)
    out = chip_smoke.lmtrain_phase(np.random.default_rng(0), tmp_path, sizes=TINY_LMTRAIN,
                                   device="cpu", lm_kw=TINY_LM_KW)
    printed = capsys.readouterr().out
    assert printed.count("[lmtrain]") == 4
    assert out["kernels"] == [] and out["busy"] is None
    assert out["mean_loss_by_pass"][-1] < out["mean_loss_by_pass"][0]
    assert out["adamw_gap"]["fed_close"] and out["stack"]["passes"] >= 1
    # 2 layers: 3 passes of 3 steps and the long pass's 2, then the runner's
    steps = 3 * 3 + 2 + out["stack"]["steps"]
    assert out["launches"] == (2 * steps,) * 3


@pytest.mark.parametrize("wrong", [None, "out", "lse"])
def test_lm_kernel_rows_hold_b1_before_the_backward(monkeypatch, capsys, wrong):
    """`lm_backward_kernel_rows` untimed on the CPU at a tiny S: B1's out
    and lse, which B2/B3 and their plain versions are both fed, are held
    against B1's plain version first, so a wrong out or lse fails the rows
    (the CPU wrappers run the plain versions: every check passes as is)."""
    from symbiont_tpu_torch.ops import flash_attention as fa

    sizes = dict(kernel_rows=2, kernel_S=(16,))
    if wrong is None:
        rows = chip_smoke.lm_backward_kernel_rows(sizes, timed=False, device="cpu")
        assert [r["shape"] for r in rows] == [
            f"q/k/v/g [2, 12, 16, 64] {d}, causal, no bias" for d in ("bfloat16", "float32")]
        assert all(set(r["fwd"]) == {"max_abs_err", "lse_rel_err"} for r in rows)
        assert capsys.readouterr().out.count("flash_attn_fwd causal") == 2
        return
    real = fa.flash_attention_with_lse

    def off(*a, **kw):
        out, lse = real(*a, **kw)
        return (out + 0.1, lse) if wrong == "out" else (out, lse + 1e-2)

    monkeypatch.setattr(fa, "flash_attention_with_lse", off)
    with pytest.raises(RuntimeError, match="lm fwd bfloat16 S=16: B1"):
        chip_smoke.lm_backward_kernel_rows(sizes, timed=False, device="cpu")


# ------------------------------------------------------------------- stack

TINY_STACK = dict(pages=4, sentences=4, queries=6, top_k=3, gen=2, gen_new=8,
                  gen_bucket=(8, 16), timeout_s=60.0)
TINY_STACK_ENGINE = dict(embedding_dim=64, length_buckets=[16, 32], batch_buckets=[2, 8],
                         max_batch=8, dtype="float32")


def test_stack_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """[stack] end to end on the CPU at tiny geometries (a 64-wide, 6-layer
    synthetic encoder, the tiny GPT-2 dir), with every check it makes on
    the card: the CPU path launches no kernel, so B1's plain forwards are
    counted as its launches and the launch equation is held on them."""
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.ops import flash_attention as fa

    params = gpt_mod.init_params(torch.Generator().manual_seed(4),
                                 gpt_mod.GPTConfig.from_hf(TINY_GPT2))
    chip_smoke.write_gpt_checkpoint(tmp_path / "gpt2", params, TINY_GPT2, torch.float32)
    forward = fa._forward

    def counted(*a, **kw):
        with fa._count_lock:
            fa.launches += 1
        return forward(*a, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    out = chip_smoke.stack_phase(np.random.default_rng(0), tmp_path, sizes=TINY_STACK,
                                 device="cpu", engine_kw=TINY_STACK_ENGINE, lm_kw=TINY_LM_KW)
    printed = capsys.readouterr().out
    # B1 at the LM's prefill shapes: 1, 2 and 4 rows in the 16 bucket
    assert printed.count("[stack] flash_attn_fwd causal") == 3
    assert "causal q[4, 4, 16, 8] over 4 KV heads, bfloat16" in printed
    assert printed.count("[stack]") == 11
    # the host-sync audit: one series per inventoried site, the streams'
    # chunks and the batched session's chunks counted at their sites
    from symbiont_tpu_torch.obs.xprof import known_sync_sites

    assert "[stack] host-sync audit:" in printed
    assert sorted(out["host_syncs"]) == list(known_sync_sites())
    assert out["host_syncs"]["LmEngine._generate_stream_impl"] >= 2 * 2
    assert out["host_syncs"]["BatchSession._step_plain"] >= 1
    assert out["host_syncs"]["TorchEngine.embed_and_search"] >= 6
    assert out["ingest"]["sentences"] == 16 and out["ingest"]["flushes"] >= 1
    assert "perception.handle" in out["ingest"]["spans"]
    assert out["search"]["fused"] == 6 and out["search"]["fallbacks"] == 0
    assert out["generate"]["requests"] == 2 and all(n >= 2 for n in out["generate"]["partials"])
    assert len(out["generate"]["direct_first_chunk_ms"]) == 2
    assert out["batched"]["requests"] == 4 and out["batched"]["sessions"] == 1
    # 6 encoder layers: 16 sentences in >= 2 batches, 6 fused queries, 6
    # rerank batches; 2 GPT-2 layers: 2 stream prefills and 1 session start
    assert out["launches"] >= 6 * (2 + 6 + 6) + 2 * 3
    assert f"{out['launches']} = 6 x (" in out["b1_equation"]


def test_a_failing_stack_check_fails_the_run(monkeypatch, capsys):
    """Every phase before [stack] stubbed to pass; a search that took the
    2-hop fallback fails [stack], which leaves main() by its exception and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: {"launches": 0},
                 session_phase=lambda rng, tmp: {"launches": 0, "batcher": {},
                                                 "tinyllama": None},
                 paged_phase=lambda rng, tmp, tl, dense_batcher: {"launches": 0},
                 spec_phase=lambda rng, tmp, tl: {"launches": 0},
                 lmtrain_phase=lambda rng, tmp: {"launches": (0, 0, 0), "kernels": []},
                 mesh_phase=lambda rng: {"launches": (0, 0, 0)},
                 tp_phase=lambda rng, tmp: {"launches": (0, 0, 0)},
                 sp_phase=lambda rng: {"launches": (0, 0, 0)},
                 stack_phase=lambda rng, tmp, serve: chip_smoke.check(
                     False, "49 of 50 searches on the fused hop, 1 fell back"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="1 fell back"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


def test_exposition_families_parse_and_refuse_a_bad_line():
    text = ("# HELP symbiont_engine_x x\n# TYPE symbiont_engine_x gauge\n"
            'symbiont_engine_x{service="engine"} 1.5\nsymbiont_span_y_count 3\n'
            'symbiont_span_y_bucket{le="+Inf"} 3\n')
    assert chip_smoke.exposition_families(text) == {"symbiont_engine_x", "symbiont_span_y_count",
                                                    "symbiont_span_y_bucket"}
    with pytest.raises(RuntimeError, match="does not parse"):
        chip_smoke.exposition_families("symbiont_engine_x{service=engine} 1\n")


def test_span_names_walks_a_trace_tree():
    tree = {"trace_id": "t", "roots": [{"name": "api.search", "children": [
        {"name": "engine.query.search", "children": []},
        {"name": "engine.rerank", "children": []}]}]}
    assert chip_smoke.span_names(tree) == {"api.search", "engine.query.search", "engine.rerank"}


# ------------------------------------------------------------------- mesh

TINY_MESH = dict(texts=24, store_rows=100, store_cap=128, queries=4, top_k=3, prompts=2, new=8,
                 prompt_bucket=16, chunk=4, llama=TINY_LLAMA,
                 gpt2=dict(TINY_GPT2, vocab_size=301), train_rows=4, train_seq=16)
TINY_MESH_ENGINE = dict(embedding_dim=32, length_buckets=[16, 32], batch_buckets=[2, 8],
                        max_batch=8, dtype="float32")


def test_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """[mesh] end to end on the CPU over meshes that repeat the CPU device,
    at tiny geometries (a 32-wide, 6-layer synthetic encoder, 2-layer llama
    and GPT-2 with an odd vocab), with every check it makes on the card:
    the CPU path launches no kernel, so B1's plain forwards and the plain
    backward are counted as the launches, and nothing captures."""
    _count_cpu_launches(monkeypatch)
    out = chip_smoke.mesh_phase(np.random.default_rng(0), sizes=TINY_MESH, device="cpu",
                                engine_kw=TINY_MESH_ENGINE)
    printed = capsys.readouterr().out
    assert printed.count("[mesh] TP decode") == 3 and printed.count("[mesh]") == 8
    assert "causal q[2, 2, 16, 8] over 1 KV heads, float32" in printed  # a TP shard's prefill
    assert "flash_attn_bwd causal q/k/v/g [2, 2, 16, 8] float32" in printed
    assert out["dp"]["cosine_min"] >= 0.999 and out["dp"]["replicas"] == 2
    assert out["store"]["same"] == out["store"]["fused_same"] == 4
    assert out["store"]["capacity"] == 128 and out["store"]["shards"] == 2
    assert [out["tp"][t]["vocab_split"] for t in ("tinyllama/none", "tinyllama/int8",
                                                  "gpt2/none")] == [True, True, False]
    # 2 layers x 2 shards x (1 generate_batch + session start + admission)
    assert all(out["tp"][t]["b1"] == 12 for t in out["tp"])
    steps = out["train"]["steps"]
    assert len(steps) == 2 and all(x["launches"] == (8, 8, 8) for x in steps)
    # 6 encoder layers x 2 replicas x batches, twice; 6 x 4 fused queries
    embed_b1 = sum(out["dp"]["b1"])
    assert embed_b1 == 6 * 2 * 2 * out["dp"]["batches"]
    assert out["launches"] == (embed_b1 + 6 * 4 + 3 * 12 + 2 * 8, 16, 16)


# --------------------------------------------------------------------- tp

TINY_TP = dict(llama=TINY_LLAMA, gpt2=TINY_GPT2, rows=2, new=8, bucket=16, chunk=4, page=4,
               spec_k=2, shared=8, tail=4, batch=2, seq_len=16,
               drafter=dict(chip_smoke.LLAMA_68M, vocab_size=300, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                            intermediate_size=48, max_position_embeddings=64))


def test_tp_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """[tp] end to end on the CPU over [1, 2] meshes that repeat the CPU
    device, at tiny geometries (2-layer llama and GPT-2, a 2-layer
    drafter), with every check it makes on the card: 9 lines (paged TP
    f32 and int8, spec dense and paged, the small drafter, the online
    trainer, the three kernel rows, untimed); B1 4 a cold prefill (2
    layers x 2 shards), 0 a full radix hit, 6 a cold spec start (4 + the
    drafter's 2), 2 a paged one that is a full radix hit; B1 = B2 = B3 = 4
    a train step, 4 passes of one step."""
    _count_cpu_launches(monkeypatch)
    out = chip_smoke.tp_phase(np.random.default_rng(0), tmp_path, sizes=TINY_TP, device="cpu")
    printed = capsys.readouterr().out
    assert printed.count("[tp]") == 9 and printed.count("[tp] paged TP") == 2
    assert printed.count("[tp] spec TP") == 3 and printed.count("[tp] online TP") == 1
    assert "flash_attn_fwd causal GQA q(2, 2, 16, 64) k(2, 1, 16, 64) float32" in printed
    assert "flash_attn_bwd causal q/k/v/g(2, 2, 16, 64) float32" in printed
    for part in ("paged", "paged_int8"):
        assert out[part]["b1"] == 12 and out[part]["radix"]["full_hits"] == 1
        assert out[part]["pages_after"][0] == 0
    for layout in ("dense", "paged"):
        spec = out["spec"][f"tinyllama/{layout}"]
        assert spec["b1"] == 6 and spec["proposed"] > 0 and spec["accepted"] == spec["proposed"]
        assert spec["warm_b1"] == (2 if layout == "paged" else 6)  # paged: a full radix hit
    online = out["online"]
    assert len(online["passes"]) == 2 and online["shard_gap"] <= 2 * 1e-4 * 2
    for p in online["passes"]:
        assert p["loss"] == pytest.approx(p["loss_ref"], rel=1e-4)
    assert online["resumed_loss"] == pytest.approx(online["unbroken_loss"], rel=1e-4)
    # 12 + 12 paged; spec 6 + 6 dense, 6 + 2 paged, 6 + 2 the small drafter
    # (a warm second session each, paged ones full radix hits); 4 x 4 train
    # steps and one generate_batch
    assert out["launches"] == (12 + 12 + 12 + 8 + 8 + 16 + 4, 16, 16)


# --------------------------------------------------------------------- sp

TINY_SP = dict(gpt2=dict(TINY_GPT2, vocab_size=301), rows=4, seq=16, pipe=2, microbatches=2,
               llama=TINY_LLAMA, llama_seq=32, kernel_rows=2, kernel_S=(16,))


def test_sp_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """[sp] end to end on the CPU over meshes that repeat the CPU device,
    at tiny geometries (2-layer GPT-2 and llama), with every check it
    makes on the card: SP ring and Ulysses steps and PP steps against the
    meshless step, the llama SP forward against the meshless forward, the
    launch equations (B1/B2/B3 per Ulysses step = 2 layers x 2 entries,
    per PP step = 2 layers x 2 microbatches; the ring launches nothing) and
    the kernel rows at Ulysses' head shards, untimed."""
    _count_cpu_launches(monkeypatch)
    out = chip_smoke.sp_phase(np.random.default_rng(0), sizes=TINY_SP, device="cpu")
    printed = capsys.readouterr().out
    assert printed.count("[sp] SP train") == 2 and printed.count("[sp] PP train") == 1
    assert printed.count("[sp] TinyLlama") == 2
    assert "flash_attn_bwd causal q/k/v/g(2, 2, 16, 64) float32" in printed
    ring, uly = out["train"]["ring"], out["train"]["ulysses"]
    assert [x["launches"] for x in ring] == [(0, 0, 0)] * 2
    assert [x["launches"] for x in uly] == [(4, 4, 4)] * 2
    assert [x["launches"] for x in out["pp"]] == [(4, 4, 4)] * 2
    for steps in (ring, uly, out["pp"]):
        assert [x["loss"] for x in steps] == pytest.approx(
            [w["loss"] for w in out["meshless"]["steps"]], rel=1e-4)
    assert out["llama"]["ring"]["cosine_min"] >= 0.99999 and out["llama"]["ulysses"]["b1"] == 4
    assert max(out["llama"][impl]["max_rel_err"] for impl in ("ring", "ulysses")) <= 1e-3
    assert out["sp_launches"] == (2 * 4 + 4, 8, 8) and out["pp_launches"] == (8, 8, 8)
    assert out["launches"] == (20, 16, 16)
    assert "[sp] flash_attn_fwd causal q/k/v(1, 2, 32, 8) float32" in printed
    assert out["llama_head_shard"]["shape"] == "q/k/v [1, 2, 32, 8] float32, causal, no bias"
    assert [r["shape"] for r in out["kernels"]] == [
        "q/k/v/g [2, 2, 16, 64] float32, causal, no bias"]


def test_a_failing_sp_check_fails_the_phase(monkeypatch):
    """A sequence-parallel loss 1% off fails [sp] at its first step's bar."""
    from symbiont_tpu_torch.parallel import context

    _count_cpu_launches(monkeypatch)
    real = context.lm_loss_sp
    monkeypatch.setattr(context, "lm_loss_sp", lambda *a, **kw: real(*a, **kw) * 1.01)
    with pytest.raises(RuntimeError, match=r"\[sp\] SP ring step 0: loss .* beyond rtol 1e-4"):
        chip_smoke.sp_phase(np.random.default_rng(0), sizes=TINY_SP, device="cpu")


def test_near_tie_argmax_parts_a_flip_at_a_tie_from_a_real_one():
    want = torch.tensor([[10.0, 9.99, 0.0], [10.0, 5.0, 0.0]])
    same = chip_smoke.near_tie_argmax(want, want)
    assert same == (0, 0)
    # row 0 flips inside 2^-8 x 10 of its top logit; row 1 flips far from it
    got = torch.tensor([[9.0, 9.5, 0.0], [1.0, 6.0, 0.0]])
    assert chip_smoke.near_tie_argmax(got, want) == (2, 1)


# --------------------------------------------------------------- multihost

TINY_SERVE = dict(llama=TINY_LLAMA, gpt2=TINY_GPT2, rows=2, new=8, bucket=16, chunk=4, page=4,
                  spec_k=2, batch=2, seq_len=16, corpus=256, dim=32, queries=4, top_k=3, fused=2,
                  engine=dict(embedding_dim=32, dtype="float32", attn_impl="flash",
                              length_buckets=[16], batch_buckets=[1, 8], max_batch=8))
# the SP/PP modes at a 4-layer tiny GPT-2: 4 heads over the 4 entries' line, 1 layer a stage
TINY_MULTIHOST_SP = dict(gpt2=dict(TINY_GPT2, n_layer=4), rows=4, seq=16, steps=2,
                         microbatches=2)
TINY_MULTIHOST = dict(gpt2=TINY_GPT2, rows=4, seq=16, steps=2, timeout_s=120, serve=TINY_SERVE,
                      sp=TINY_MULTIHOST_SP)


def test_multihost_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """[multihost] end to end on the CPU: two worker processes in one gloo
    world, 2 entries each, the tiny GPT-2 (2 layers, a vocab of 300 that
    splits over 'tensor') over [2, 1] and [2, 2] spanning them, then the
    serve mode over [1, 2] and [2, 1] of one entry a process (the tiny
    llama and GPT-2, a 256-row store and a 6-layer encoder's fused
    queries), and the SP/PP modes over a line of all 4 entries (a 4-layer
    tiny GPT-2: ring, Ulysses, GPipe), every bar it holds on the card;
    each worker counts its plain attention calls as launches (2 layers x
    local entries a step, 2 layers x 1 shard a cold prefill; the SP/PP
    launch equations scaled to the tiny model)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the workers' torch threads
    out = chip_smoke.multihost_phase(np.random.default_rng(0), sizes=TINY_MULTIHOST,
                                     device="cpu")
    printed = capsys.readouterr().out
    # 11 lines of train and serve; the SP/PP modes' 3, and B1 and B2/B3 at their 2 shards
    assert printed.count("[multihost] 2 processes") == 1 and printed.count("[multihost]") == 18
    assert printed.count("[multihost] serve:") == 3
    assert "over gloo (entries on the CPU)" in printed
    # B1 and B2/B3 against plain at each mode's local shard [rows / data, heads / tensor, ...]
    assert "flash_attn_fwd causal q/k/v(2, 4, 16, 8) float32" in printed
    assert "flash_attn_bwd causal q/k/v/g [2, 2, 16, 8] float32 (tp's local shard)" in printed
    assert [out["shard_errs"][m]["shape"] for m in ("dp", "tp")] == [[2, 4, 16, 8], [2, 2, 16, 8]]
    dp, tp = out["modes"]["dp"], out["modes"]["tp"]
    assert (dp["mesh"], dp["local_entries"], tp["mesh"], tp["local_entries"]) == \
        ([2, 1], 1, [2, 2], 2)
    for mode in (dp, tp):
        assert [{k: x[k] for k in ("loss", "grad_norm", "launches", "bytes")}
                for x in mode["steps"]] == \
            [{k: x[k] for k in ("loss", "grad_norm", "launches", "bytes")}
             for x in mode["steps_other"]]
        assert [x["loss"] for x in mode["steps"]] == pytest.approx(
            [x["loss"] for x in out["meshless"]], rel=1e-4)
    # dp sums every gradient across the processes; tp only the replicated leaves'
    geom = chip_smoke.gpt_param_count(TINY_GPT2)
    assert dp["grad_bytes"] == 4 * geom and 0 < tp["grad_bytes"] < dp["grad_bytes"]
    assert dp["bytes_per_step"] >= dp["grad_bytes"]
    # train, per worker and step: 2 layers x 1 entry (dp), x 2 entries (tp); 2 steps, 2
    # workers. Serve, per worker: B1 2 layers x 1 shard at the dense and paged batches and
    # the paged cold start, 2 + 2 (the drafter) at the spec start, 2 an online step and 2 at
    # the batch after it, 6 encoder layers x 2 fused queries; B2/B3 2 an online step
    sv = out["serve"]
    assert sv["launches"] == {"dense": 2, "paged": 2, "spec_start": 4, "online": [[2, 2, 2]],
                              "fused": 12}
    assert sv["b123"] == [2 * (2 + 2 + 2 + 4 + 2 + 2 + 12), 2 * 2, 2 * 2]
    # SP/PP, per worker and step (24 / 24 / 0 on the card): the ring 0; Ulysses 4 layers x 2
    # local entries; the pipeline 1 layer a stage x 2 local stages x 2 microbatches
    spo = out["sp"]
    for mode, eq in (("ring", 0), ("ulysses", 8), ("pp", 4)):
        steps = spo[mode]["steps"]
        assert [x["launches"] for x in steps + spo[mode]["steps_other"]] == [[eq] * 3] * 4
        assert [(x["loss"], x["grad_norm"]) for x in steps] == \
            [(x["loss"], x["grad_norm"]) for x in spo[mode]["steps_other"]]
        assert [x["loss"] for x in steps] == pytest.approx(
            [x["loss"] for x in spo["meshless"]], rel=1e-4)
        assert spo[mode]["local_entries"] == 2 and steps[0]["bytes"] > 0
    assert spo["b123"] == [2 * 2 * (0 + 8 + 4)] * 3
    assert [spo["kernels"][m]["shape"] for m in ("ulysses", "pp")] == [
        "q/k/v/g [4, 1, 16, 64] float32, causal, no bias",
        "q/k/v/g [2, 4, 16, 64] float32, causal, no bias"]
    assert printed.count("[multihost] SP/PP") == 3
    assert out["launches"] == tuple(2 * 2 * (2 * 1 + 2 * 2) + n + m
                                    for n, m in zip(sv["b123"], spo["b123"]))
    assert sv["online"]["loss"] == pytest.approx(sv["online"]["ref_loss"], rel=1e-4)
    assert len(sv["decode"]["bytes_step"]) == 2 and sv["decode"]["bytes_step"][0] > 0
    assert sv["store"]["local_rows"] == 128


def test_a_multihost_worker_that_breaks_a_bar_fails_the_phase(monkeypatch):
    """A learning rate of 1e30 sends step 1's loss to nan in both workers:
    the bar against the meshless step fails the phase (the serve mode
    off)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    with pytest.raises(RuntimeError, match=r"\[multihost\] dp"):
        chip_smoke.multihost_phase(np.random.default_rng(0),
                                   sizes=dict(TINY_MULTIHOST, lr=1e30, serve=None, sp=None),
                                   device="cpu")


def test_a_failing_multihost_worker_fails_the_run(monkeypatch, capsys):
    """Every phase before [multihost] stubbed to pass; workers asked for a
    mesh their world cannot hold exit non-zero, which fails [multihost]
    with their exit codes and leaves main() by its exception, printing no
    result (the serve mode off: the stubbed `synth_texts` gives it no
    prompts)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    real = chip_smoke.multihost_phase
    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: {"launches": 0},
                 session_phase=lambda rng, tmp: {"launches": 0, "batcher": {},
                                                 "tinyllama": None},
                 paged_phase=lambda rng, tmp, tl, dense_batcher: {"launches": 0},
                 spec_phase=lambda rng, tmp, tl: {"launches": 0},
                 lmtrain_phase=lambda rng, tmp: {"launches": (0, 0, 0), "kernels": []},
                 mesh_phase=lambda rng: {"launches": (0, 0, 0)},
                 tp_phase=lambda rng, tmp: {"launches": (0, 0, 0)},
                 sp_phase=lambda rng: {"launches": (0, 0, 0)},
                 stack_phase=lambda rng, tmp, serve: {"launches": 0},
                 fleet_phase=lambda rng, tmp: {"launches": 0},
                 multihost_phase=lambda rng: real(
                     rng, sizes=dict(TINY_MULTIHOST, modes=(("dp", (3, 1)),), serve=None,
                                     sp=None),
                     device="cpu"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match=r"(?s)\[multihost\] a worker failed .* exit codes "
                                           r"\[.*is not \[3, 1\] over both processes"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


def test_a_failing_exchange_fails_the_multihost_phase(tmp_path, monkeypatch):
    """Process 1's point-to-point exchange raises at the ring's first hop
    (a `sitecustomize` on the workers' path replaces `Group.exchange`):
    the worker exits non-zero, its peer is stopped, and the phase fails
    naming the error; no fallback runs the hop another way."""
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {str(Path(chip_smoke.__file__).parent)!r})\n"
        "if os.environ.get('SYMBIONT_PROCESS_ID') == '1':\n"
        "    from symbiont_tpu_torch.parallel import mesh\n"
        "    def broken(self, sends, recvs):\n"
        "        raise RuntimeError('the exchange is broken')\n"
        "    mesh.Group.exchange = broken\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    with pytest.raises(RuntimeError, match=r"(?s)\[multihost\] a worker failed .* exit codes "
                                           r".*the exchange is broken"):
        chip_smoke.multihost_phase(np.random.default_rng(0), device="cpu", sizes=dict(
            TINY_MULTIHOST, serve=None, sp=dict(TINY_MULTIHOST_SP, modes=("ring",))))


# ------------------------------------------------------------------- lint


def test_lint_phase_is_clean_on_the_checkout(capsys):
    """[lint] over this checkout: every rule, the port's allowlist, 0
    findings, one line."""
    from symbiont_tpu_torch.lint.rules import RULES

    out = chip_smoke.lint_phase()
    assert out["findings"] == 0 and out["rules"] == len(RULES) and out["files"] > 100
    printed = capsys.readouterr().out
    assert printed.count("[lint]") == 1 and ": 0 findings" in printed


def test_a_lint_finding_fails_the_run(tmp_path, monkeypatch, capsys):
    """Every phase before [lint] stubbed to pass; a checkout whose engine
    takes a per-scalar sync fails [lint], which leaves main() by its
    exception and prints no result."""
    from tests.test_torch_lint import _wiring_tree

    _wiring_tree(tmp_path)
    (tmp_path / "symbiont_tpu_torch" / "engine").mkdir()
    (tmp_path / "symbiont_tpu_torch" / "engine" / "lm.py").write_text(
        "def f(x):\n    return x.item()\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 700.00 W")
    launches = {"launches": (0, 0, 0)}

    def checkpoint(rng, tmp):
        (Path(tmp) / "mpnet").mkdir()
        return {"launches": 0, "mpnet_dir": Path(tmp) / "mpnet", "host_leaves": {}}

    real = chip_smoke.lint_phase
    stubs = dict(kernel_phase=lambda: {}, backward_kernel_phase=lambda: {},
                 main_path=lambda rng: launches, train_path=lambda rng: launches,
                 profile_embed=lambda texts: None, synth_texts=lambda rng, n: [],
                 checkpoint_phase=checkpoint, obs_phase=lambda ck, tmp: None,
                 quant_phase=lambda rng, d, h: {"launches": 0},
                 causal_gqa_kernel_phase=lambda: {},
                 generate_phase=lambda rng, tmp: {"launches": 0},
                 session_phase=lambda rng, tmp: {"launches": 0, "batcher": {},
                                                 "tinyllama": None},
                 paged_phase=lambda rng, tmp, tl, dense_batcher: {"launches": 0},
                 spec_phase=lambda rng, tmp, tl: {"launches": 0},
                 lmtrain_phase=lambda rng, tmp: {"launches": (0, 0, 0), "kernels": []},
                 mesh_phase=lambda rng: {"launches": (0, 0, 0)},
                 tp_phase=lambda rng, tmp: {"launches": (0, 0, 0)},
                 sp_phase=lambda rng: {"launches": (0, 0, 0)},
                 stack_phase=lambda rng, tmp, serve: {"launches": 0},
                 fleet_phase=lambda rng, tmp: {"launches": 0},
                 multihost_phase=lambda rng: {"launches": (0, 0, 0)},
                 lint_phase=lambda: real(tmp_path))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match=r"(?s)the port's linter found:.*"
                                           r"torch-host-sync-in-loop.*subject-dead-limb"):
        chip_smoke.main()
    printed = capsys.readouterr().out
    assert "[lint]" in printed and '"ok": true' not in printed


def _sync_registry(*sites):
    from symbiont_tpu_torch.obs.xprof import DispatchLedger
    from symbiont_tpu_torch.utils.telemetry import Metrics

    ledger = DispatchLedger(registry=Metrics())
    ledger.register_zero()
    for site in sites:
        ledger.note_host_sync(site)
    return ledger.registry


def test_sync_audit_counts_each_inventoried_site():
    registry = _sync_registry("TorchEngine.rerank", "TorchEngine.rerank")
    before = chip_smoke.host_sync_counts(registry)
    registry.inc("engine.host_syncs_total", 3, labels={"site": "TorchEngine.rerank"})
    got = chip_smoke.sync_audit(registry, before)
    assert got["TorchEngine.rerank"] == 3 and sum(got.values()) == 3
    assert chip_smoke.host_sync_counts(registry)["TorchEngine.rerank"] == 5


@pytest.mark.parametrize("fault, match", [
    ("outside", r"counted at sites the inventory does not name: \['Nowhere.sync'\]"),
    ("missing", r"series .* are not known_sync_sites\(\)"),
])
def test_sync_audit_fails(fault, match):
    """A series outside the inventory that fired, or an inventoried site
    with no series (register_zero not run), fails the audit."""
    from symbiont_tpu_torch.utils.telemetry import Metrics

    if fault == "outside":
        registry = _sync_registry("TorchEngine.warmup", "Nowhere.sync")
    else:
        registry = Metrics()
        registry.inc("engine.host_syncs_total", 1, labels={"site": "TorchEngine.warmup"})
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.sync_audit(registry)
