"""The device-free parts of chip_smoke.py: the bounds it computes from
shapes, the bars it holds the backward kernels to, the parameter and byte
counts and the checkpoint writers of its checkpoint, quantization and
generate phases, the generate phase's real-rows comparison, and its
refusal to run without a CUDA card (it must print no result there) or to
finish when a check fails."""

import dataclasses
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
                    later_waves=(4, 4, 4, 4, 16, 12, 8, 4), wave_gap_s=0.0)


def test_session_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """[session] end to end on the CPU at tiny geometries, with every check
    it makes on the card. The CPU path launches no kernel, so the plain
    forwards of B1 are counted as its launches."""
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
    out = chip_smoke.session_phase(
        np.random.default_rng(0), tmp_path, sizes=TINY_SESSION, device="cpu",
        lm_kw=dict(force_cpu=True, prompt_buckets=[8, 16, 32], new_token_buckets=[4, 16]))
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
                 session_phase=lambda rng, tmp: chip_smoke.check(False, "admitted_midflight 0"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="admitted_midflight 0"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


# ------------------------------------------------------------ paged, spec

TINY_PAGED = dict(TINY_SESSION, bucket=(8, 16), new=16, prefix=8, page=4, spec_k=4,
                  verify_rows=2, verify_cache=32,
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
    corrupted and small-drafter sessions and the verify check."""
    tmp, tinyllama = tiny_dirs
    out = chip_smoke.spec_phase(np.random.default_rng(0), tmp, tinyllama, sizes=TINY_PAGED,
                                device="cpu", lm_kw=TINY_LM_KW)
    printed = capsys.readouterr().out
    assert printed.count("[spec] flash_attn_fwd causal") == 3  # B1 at its new shapes
    assert printed.count("[spec]") == 7
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
                     False, "self-drafted stream: 0 draft tokens proposed"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="0 draft tokens proposed"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out
