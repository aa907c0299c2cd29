"""The port's LmEngine (symbiont_tpu_torch/engine/lm.py) against the JAX
LmEngine on the CPU, at tiny geometries: the same prompt buckets, trims and
batch padding, greedy text token-identical on the same weights (dense and
int8 KV, quantized weights), int8/fp8 codes bit-equal, the same parameter
bytes; plus the host-side pieces (byte tokenizer, incremental decoder,
config) and the paged layout and drafters under a TP mesh, against
JAX's TP engine."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from symbiont_tpu.config import LmConfig as JaxLmConfig
from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu.models import quant as jquant
from symbiont_tpu.parallel import build_mesh as jax_build_mesh
from symbiont_tpu_torch.config import LmConfig
from symbiont_tpu_torch.engine.lm import (
    ByteTokenizer,
    IncrementalDecoder,
    LmEngine,
    _round_up,
)
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models import quant
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
from symbiont_tpu_torch.obs.hbm import hbm_ledger
from symbiont_tpu_torch.parallel import build_mesh
from symbiont_tpu_torch.utils.telemetry import metrics

TINY = dict(enabled=True, arch="llama", hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_positions=256, dtype="float32",
            prompt_buckets=[8, 16, 64], new_token_buckets=[8, 16], temperature=0.0)
PROMPTS = ["hello", "a much longer prompt with many words in it", "", "byteés"]


def _port(**kw):
    return LmEngine(LmConfig(**{**TINY, **kw}), device="cpu")


def _pair(arch="llama", nkv=2, seed=4, **kw):
    """A JAX and a port LmEngine on the same weights: a byte-vocab model of
    TINY's width, its kernels ×8 off JAX's init so greedy text moves."""
    jcfg = jgpt.GPTConfig(vocab_size=257, hidden_size=32, num_layers=2, num_heads=4,
                          num_kv_heads=nkv, intermediate_size=64, max_position_embeddings=256,
                          arch=arch, dtype="float32", tie_word_embeddings=arch == "gpt2")
    tree = jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(seed), jcfg))
    cfg = {**TINY, "arch": arch, **kw}
    jax_eng = JaxLmEngine(JaxLmConfig(**cfg), params=tree, model_cfg=jcfg)
    port = LmEngine(LmConfig(**cfg), params=gpt_params_from_numpy(tree, "cpu"),
                    model_cfg=tgpt.GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jax_eng, port


# ------------------------------------------------------------ host pieces


def test_byte_tokenizer_roundtrip():
    t = ByteTokenizer()
    for s in ["hello world", "юникод работает", "emoji 🌱 ok", ""]:
        ids = t.encode(s, 512)
        assert ids[0] == t.bos_id
        assert t.decode(ids) == s
    assert len(t.encode("x" * 100, 8)) == 8


def test_round_up():
    assert _round_up(1, [8, 16]) == 8
    assert _round_up(9, [8, 16]) == 16
    assert _round_up(99, [8, 16]) == 16  # clamps at the top bucket


def test_incremental_decoder_multibyte_straddle():
    tok = ByteTokenizer()
    full = list("héllo".encode("utf-8"))  # 'é' split between its two bytes
    d = IncrementalDecoder(tok)
    out = d.push(full[:2])
    assert out == "h"
    out += d.push(full[:4])
    out += d.push(full)
    out += d.flush(full)
    assert out == "héllo"


def test_incremental_decoder_invalid_bytes_and_rewrites():
    d = IncrementalDecoder(ByteTokenizer())
    toks = list(b"ok\xc3")  # a dangling lead byte surfaces at flush
    assert d.push(toks) + d.flush(toks) == "ok�"

    class Rewrites:
        def decode(self, ids):
            return "ab" if len(ids) < 3 else "aXc"

    d = IncrementalDecoder(Rewrites())
    assert d.push([1, 2]) == "ab"
    assert d.push([1, 2, 3]) == ""
    assert d.flush([1, 2, 3]) == "Xc"


def test_config_defaults_match_jax():
    mine = dataclasses.asdict(LmConfig())
    assert mine.pop("force_cpu") is False
    assert mine == dataclasses.asdict(JaxLmConfig())


@pytest.mark.parametrize("kw", [dict(quantize="int4"), dict(kv_quant="fp8"),
                                dict(tensor_parallel="maybe"), dict(stream_chunk=24,
                                                                    new_token_buckets=[64]),
                                dict(kv_layout="paged", prompt_buckets=[12])])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxLmConfig(**kw)
    with pytest.raises(ValueError):
        LmConfig(**kw)


TP_MESH = build_mesh([1, 2], devices=[torch.device("cpu")] * 2)


@pytest.mark.parametrize("config_kw,engine_kw,item", [
    (dict(kv_layout="paged", kv_page_tokens=8), dict(mesh=TP_MESH), "paged"),
    (dict(spec_draft_model="/no/such/drafter"), dict(mesh=TP_MESH), "missing drafter"),
    ({}, dict(mesh=TP_MESH, draft_params="same", draft_model_cfg="same"), "drafter"),
])
def test_unported_settings_raise_and_name_their_item(config_kw, engine_kw, item, caplog):
    """Under a TP mesh the paged layout and a drafter (the target itself)
    serve JAX's TP engine's greedy tokens on one tree; a drafter dir that
    is missing decodes plain with a warning, as without a mesh. (Each was
    once refused under TP; tests/test_torch_tp_serving.py holds the
    three to JAX at length.)"""
    kw = dict(kv_layout="paged", kv_page_tokens=8) if item == "paged" else {}
    jax_eng, port = _pair(**kw)
    jd = {}
    if item == "drafter":
        engine_kw = dict(engine_kw, draft_params=port.params, draft_model_cfg=port.model_cfg)
        jd = dict(draft_params=jax_eng.params, draft_model_cfg=jax_eng.model_cfg)
    jax_eng = JaxLmEngine(jax_eng.config, params=jax_eng.params, model_cfg=jax_eng.model_cfg,
                          mesh=jax_build_mesh([1, 2], devices=jax.devices()[:2]), **jd)
    tp = LmEngine(LmConfig(**{**TINY, **config_kw}), params=port.params,
                  model_cfg=port.model_cfg, device="cpu", **engine_kw)
    assert tp.mesh is not None and jax_eng.mesh is not None
    assert (tp.pool is not None) == (item == "paged")
    assert (tp._draft is not None) == (item == "drafter")
    if item == "missing drafter":
        assert any("spec_draft_model" in r.getMessage() for r in caplog.records)
    assert tp.generate_batch(PROMPTS, [12] * 4) == jax_eng.generate_batch(PROMPTS, [12] * 4)


@pytest.mark.parametrize("config_kw,engine_kw", [
    (dict(kv_layout="paged", kv_page_tokens=8), {}),
    (dict(spec_draft_model="/no/such/drafter"), {}),
    ({}, dict(draft_params="same", draft_model_cfg="same")),
])
def test_paged_and_spec_settings_are_ported(config_kw, engine_kw):
    """kv_layout="paged", a drafter dir (missing here: speculation off with
    a warning, as in JAX) and draft params (the target's own) construct an
    engine that generates (tests/test_torch_kv_paged.py and
    tests/test_torch_spec.py hold them to JAX)."""
    if engine_kw:
        donor = _port()
        engine_kw = dict(draft_params=donor.params, draft_model_cfg=donor.model_cfg)
    eng = LmEngine(LmConfig(**{**TINY, **config_kw}), device="cpu", **engine_kw)
    assert (eng.pool is not None) == ("kv_layout" in config_kw)
    assert (eng._draft is not None) == bool(engine_kw)
    assert isinstance(eng.generate("hello", 8), str)


def test_journal_is_not_ported(tmp_path):
    """The journal is ported (ROADMAP A8 stage 2; tests/test_torch_resume.py
    holds it to JAX's): an engine starts without one, as JAX's does, and a
    journal set on it records the streams that carry a task id, and only
    those."""
    from symbiont_tpu_torch.resilience.genlog import GenJournal

    eng = _port(stream_chunk=4)
    assert eng.journal is None
    eng.journal = GenJournal(tmp_path / "lm.genlog")
    text = "".join(eng.generate_stream("hello", 8, task_id="t-1"))
    "".join(eng.generate_stream("hello", 8))
    tails = eng.journal.live_tails()
    assert list(tails) == ["t-1"] and len(tails["t-1"]["tokens"]) == 8
    assert text == eng.generate("hello", 8)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LmEngine(LmConfig(**TINY))


def test_force_cpu_synthetic_engine():
    eng = LmEngine(LmConfig(**TINY, force_cpu=True, attn_impl="auto"))
    assert eng.device.type == "cpu" and eng.model_cfg.attn_impl == "xla"
    assert eng.model_cfg.vocab_size == ByteTokenizer.vocab_size
    assert isinstance(eng.tokenizer, ByteTokenizer)
    assert eng.params["wte"].dtype == torch.float32
    with pytest.raises(ValueError, match="attn_impl"):
        LmEngine(LmConfig(**TINY, attn_impl="fast"), device="cpu")


# ---------------------------------------------------------- prompt shapes


@pytest.fixture(scope="module")
def engines():
    return _pair()


@pytest.mark.parametrize("prompts,max_new,min_rows", [
    (["seed text"], 8, 1),
    (PROMPTS, 8, 1),
    (PROMPTS[:3], 16, 1),
    (["x" * 200], 16, 1),          # past the cap: tail-trimmed to the largest bucket
    (["a" * 5000 + "ZQX"], 8, 1),  # the tail wins
    ([""], 3, 4),                  # BOS fallback, rows reserved
    (["p"] * 5, 9, 1),             # batch bucket 8, new bucket 16
])
def test_prepare_prompts_matches_jax(engines, prompts, max_new, min_rows):
    jax_eng, port = engines
    want = jax_eng._prepare_prompts(prompts, max_new, min_rows)
    got = port._prepare_prompts(prompts, max_new, min_rows)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.int32 and np.array_equal(g, w)


def test_prompt_bucket_never_overflows_positions():
    # P + new_bucket must fit the positions: a 64-position model with new
    # bucket 16 cannot use the 64 bucket, so prompts stop at 16
    eng = _port(num_layers=1, max_positions=64, new_token_buckets=[16])
    ids, mask, new = eng._prepare_prompts(["x" * 200], 16)
    assert ids.shape == (1, 16) and new == 16 and mask.sum() == 16
    only = _port(num_layers=1, max_positions=40, prompt_buckets=[64], new_token_buckets=[16])
    assert only._prepare_prompts(["x" * 200], 16)[0].shape == (1, 24)  # no bucket fits: the cap
    assert isinstance(eng.generate("x" * 200, 16), str)
    small = _port(num_layers=1, max_positions=8, prompt_buckets=[8], new_token_buckets=[16])
    with pytest.raises(ValueError):
        small.generate("hi", 16)


def test_long_prompt_keeps_tail():
    eng = _port()
    ids, mask, _ = eng._prepare_prompts(["a" * 5000 + "ZQX"], 8)
    assert eng.tokenizer.decode(ids[0][mask[0] == 1]).endswith("ZQX")
    assert isinstance(eng.generate("a" * 5000 + "ZQX", 8), str)


# ------------------------------------------------------------- generation


@pytest.mark.parametrize("arch,nkv,kw", [
    ("llama", 2, {}),
    ("gpt2", None, {}),
    ("llama", 2, dict(attn_impl="flash")),
    ("gpt2", None, dict(attn_impl="flash")),
    ("llama", 2, dict(kv_quant="int8")),
    ("llama", 2, dict(quantize="int8")),
    ("gpt2", None, dict(quantize="fp8", kv_quant="int8")),
])
def test_generate_batch_greedy_matches_jax(arch, nkv, kw):
    jax_eng, port = _pair(arch, nkv, **kw)
    want = jax_eng.generate_batch(PROMPTS, [8, 5, 8, 3])
    got = port.generate_batch(PROMPTS, [8, 5, 8, 3])
    assert got == want
    assert len(set(got)) > 1 and max(len(t) for t in got) > 0
    assert port.stats["generate_calls"] == 1
    assert port.stats["tokens_generated"] == jax_eng.stats["tokens_generated"]


def test_generate_batch_greedy_matches_singles(engines):
    _, port = engines
    singles = [port.generate(p, 8) for p in PROMPTS]
    assert port.generate_batch(PROMPTS, [8] * len(PROMPTS)) == singles


def test_generate_batch_per_request_trim(engines):
    jax_eng, port = engines
    before = port.stats["tokens_generated"]
    got = port.generate_batch(["x", "x"], [2, 8])  # one new-token bucket, trimmed per row
    assert port.stats["tokens_generated"] - before <= 2 + 8
    assert got == jax_eng.generate_batch(["x", "x"], [2, 8])
    assert got == [port.generate("x", 2), port.generate("x", 8)]
    with pytest.raises(ValueError, match="mismatch"):
        port.generate_batch(["x"], [2, 3])
    with pytest.raises(ValueError, match="length"):
        port.generate_batch(["x", "y"], [2, 3], temperature=[0.5])


def test_sampled_generation_is_seeded():
    """Sampled text comes from the engine's generator: the same seed gives
    the same text, calls advance it, and temperature 0 rows stay greedy."""
    a, b = _port(temperature=1.0, top_k=20), _port(temperature=1.0, top_k=20)
    first = a.generate_batch(PROMPTS, [16] * 4)
    assert b.generate_batch(PROMPTS, [16] * 4) == first
    assert a.generate_batch(PROMPTS, [16] * 4) != first
    greedy = a.generate_batch(PROMPTS[:2], [8, 8], temperature=[0.0, 1.0])[0]
    assert greedy == _port().generate(PROMPTS[0], 8)


def test_flash_engine_matches_plain_engine():
    _, xla = _pair()
    _, flash = _pair(attn_impl="flash")
    assert flash.model_cfg.attn_impl == "flash"
    assert flash.generate_batch(PROMPTS, [8] * 4) == xla.generate_batch(PROMPTS, [8] * 4)


def test_stats_gauge_warmup_and_update_params(engines):
    _, port = _pair()
    port.warmup()
    assert port.stats["generate_calls"] == 1 and port.stats["decode_s"] > 0
    rate = metrics.gauge_get("lm.decode_tok_per_s", {"service": "lm", "kv_dtype": "float32"})
    assert rate == pytest.approx(port.stats["tokens_generated"] / port.stats["decode_s"])
    before = port.generate("swap", 8)
    jax_eng, _ = engines
    params = jax.tree.map(np.asarray, jax_eng.params)
    port.update_params(gpt_params_from_numpy(params, "cpu"))
    assert port.generate("swap", 8) == jax_eng.generate("swap", 8)
    assert isinstance(before, str)


# ----------------------------------------------------- placement and bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "f16", "int8", "fp8"])
def test_placement_bytes_and_codes_match_jax(mode, dtype):
    """Cast first, quantize second, as the JAX `_place_params`: the same
    bytes and gauge label, int8/fp8 codes and scales bit-equal, bf16 leaves
    never widened (f16 at float32 compute holds bf16 matrices)."""
    jax_eng, port = _pair(quantize=mode, dtype=dtype)
    assert port.param_bytes() == jquant.param_bytes(jax_eng.params)
    label = mode if mode != "none" else dtype
    assert metrics.gauge_get("lm.param_bytes", {"service": "lm", "dtype": label}) == \
        port.param_bytes()
    row = {r["subsystem"]: r["bytes"] for r in hbm_ledger.rows()}
    assert row["lm.params"] >= port.param_bytes()
    got, want = port.params["layers"][1]["mlp"]["down"]["kernel"], \
        jax_eng.params["layers"][1]["mlp"]["down"]["kernel"]
    if mode in ("int8", "fp8"):
        assert quant.is_quantized(got) and jquant.is_quantized(want)
        assert np.array_equal(got.q.view(torch.uint8).numpy(),
                              np.asarray(want.q).view(np.uint8))
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    else:
        narrow = mode == "f16" or dtype == "bfloat16"
        assert got.dtype == (torch.bfloat16 if narrow else torch.float32)
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert port.params["ln_f"]["scale"].dtype == tgpt.torch_dtype(dtype)
