"""The port's decoder LM (symbiont_tpu_torch/models/gpt.py) against the JAX
package's on the same weights, on the CPU at a tiny geometry (vocab 97,
hidden 32, 2 layers, 4 heads; llama with 2 KV heads). The JAX flash prefill
runs its Pallas kernel in interpret mode, the port the kernel's plain
version. Bars: float32 logits within atol 2e-5 / rtol 1e-4 (flash 2e-4, the
encoder's bar) at real positions only (a padding row under causal attention
sees only masked keys, and its value there depends on the kernel's blocks);
bf16 next-token distributions at cosine >= 0.999; greedy decode
token-identical. Also the checkpoint converter's GPT half against the JAX
converter's, bit for bit."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbiont_tpu.models import convert as jconvert
from symbiont_tpu.models import gpt as jgpt
from symbiont_tpu_torch.models import convert
from symbiont_tpu_torch.models import gpt as tgpt
from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy

F32 = dict(atol=2e-5, rtol=1e-4)
FLASH = dict(atol=2e-4, rtol=2e-4)
ARCHS = [("gpt2", None), ("llama", 2)]
B, P, NEW = 3, 16, 6
LENGTHS = [16, 9, 4]  # ragged rows, right-aligned inside the prefill


def _cfgs(arch, nkv, dtype="float32", attn_impl="xla", kv_quant="none"):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=nkv,
              intermediate_size=64, max_position_embeddings=64, arch=arch, dtype=dtype,
              tie_word_embeddings=arch == "gpt2", attn_impl=attn_impl, kv_quant=kv_quant)
    return jgpt.GPTConfig(**kw), tgpt.GPTConfig(**kw)


def _params(arch, nkv, seed=3):
    """JAX init_params, then every leaf moved off its init (kernels and
    tables ×8, vectors jittered), so greedy decode does not settle on one
    token; the same numpy tree for both packages."""
    jcfg, _ = _cfgs(arch, nkv)
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.ndim >= 2:
            return (a * 8).astype(np.float32)
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)

    tree = jax.tree.map(move, jgpt.init_params(jax.random.key(seed), jcfg))
    return tree, gpt_params_from_numpy(tree, "cpu")


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), np.int32)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(1, 97, n)
        mask[i, :n] = 1
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _prefill_both(arch, nkv, attn_impl, dtype="float32", kv_quant="none"):
    jcfg, tcfg = _cfgs(arch, nkv, dtype, attn_impl, kv_quant)
    jp, tp = _params(arch, nkv)
    ids, mask = _prompts()
    jp_c = jax.tree.map(jnp.asarray, jp)
    jcache = jgpt.init_cache(jcfg, B, P + NEW, jnp.dtype(dtype))
    ids_r, pos, kv_valid, plen = jgpt._align_prompt(jnp.asarray(ids), jnp.asarray(mask), NEW)
    jlog, jcache = jgpt.forward(jp_c, ids_r, jcache, pos, jcfg, kv_valid)
    tcache = tgpt.init_cache(tcfg, B, P + NEW, tgpt.torch_dtype(dtype))
    t_ids, t_pos, t_kv, t_plen = tgpt._align_prompt(_t(ids), _t(mask), NEW)
    tlog, tcache = tgpt.forward(tp, t_ids, tcache, t_pos, tcfg, t_kv)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp_c, tp=tp, jlog=np.asarray(jlog), tlog=tlog,
                jcache=jcache, tcache=tcache, kv_valid=np.asarray(kv_valid), plen=plen,
                t_kv=t_kv, t_plen=t_plen)


def test_align_prompt_matches_jax():
    ids, mask = _prompts(4)
    want = jgpt._align_prompt(jnp.asarray(ids), jnp.asarray(mask), NEW)
    got = tgpt._align_prompt(_t(ids), _t(mask), NEW)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_forward_logits_and_cache_match_jax(arch, nkv, attn_impl):
    """Prefill logits at real positions and the KV cache where kv_valid is
    true, then one decode step against the populated cache (all rows)."""
    tol = F32 if attn_impl == "xla" else FLASH
    r = _prefill_both(arch, nkv, attn_impl)
    real = r["kv_valid"][:, :P]
    np.testing.assert_allclose(r["tlog"].numpy()[real], r["jlog"][real], **tol)
    valid = r["kv_valid"]
    for name in ("k", "v"):
        got = getattr(r["tcache"], name).numpy()[:, valid]
        want = np.asarray(getattr(r["jcache"], name))[:, valid]
        np.testing.assert_allclose(got, want, **tol)
    # one decode step: the next token of every row at its own position
    tok = r["jlog"][:, -1].argmax(-1).astype(np.int32)[:, None]
    jcache = r["jcache"]._replace(length=jnp.asarray(P, jnp.int32))
    jl1, _ = jgpt.forward(r["jp"], jnp.asarray(tok), jcache, r["plen"][:, None], r["jcfg"],
                          jnp.asarray(valid))
    tl1, tcache = tgpt.forward(r["tp"], _t(tok), r["tcache"]._replace(length=P),
                               r["t_plen"][:, None], r["tcfg"], r["t_kv"])
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **tol)
    assert tcache.length == P  # forward leaves the length to its caller


@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_flash_forward_over_a_filled_cache_reads_the_cache(arch, nkv):
    """A forward of S > 1 tokens over a non-empty cache (a speculative
    verify or tracking window) under attn_impl="flash" attends over the
    whole cache, as JAX's "xla" does: 4 tokens over an 8-token cache. The
    JAX flash branch attends over the 4 fresh tokens only (ROADMAP, "Facts
    a parity test meets"; checked here too), so the port takes its kernel
    only from an empty cache."""
    jcfg, _ = _cfgs(arch, nkv, attn_impl="xla")
    _, tcfg = _cfgs(arch, nkv, attn_impl="flash")
    jp, tp = _params(arch, nkv)
    jp = jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 97, (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    kv = np.ones((2, 16), bool)
    jcache = jgpt.init_cache(jcfg, 2, 16, jnp.float32)
    _, jcache = jgpt.forward(jp, jnp.asarray(ids[:, :8]), jcache, jnp.asarray(pos[:, :8]), jcfg,
                             jnp.asarray(kv))
    want, _ = jgpt.forward(jp, jnp.asarray(ids[:, 8:]), jcache._replace(length=jnp.asarray(8)),
                           jnp.asarray(pos[:, 8:]), jcfg, jnp.asarray(kv))
    tcache = tgpt.init_cache(tcfg, 2, 16, torch.float32)
    _, tcache = tgpt.forward(tp, _t(ids[:, :8]), tcache, _t(pos[:, :8]), tcfg,
                             torch.from_numpy(kv))
    got, _ = tgpt.forward(tp, _t(ids[:, 8:]), tcache._replace(length=8), _t(pos[:, 8:]), tcfg,
                          torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    jax_flash, _ = jgpt.forward(jp, jnp.asarray(ids[:, 8:]),
                                jcache._replace(length=jnp.asarray(8)), jnp.asarray(pos[:, 8:]),
                                dataclasses.replace(jcfg, attn_impl="flash"), jnp.asarray(kv))
    off = float(np.abs(np.asarray(jax_flash) - np.asarray(want)).max())
    assert off > 100 * F32["atol"], off  # the JAX flash branch drops the cache


def _softmax_cos(a, b):
    pa = torch.softmax(torch.from_numpy(np.array(a, np.float32)), -1)
    pb = torch.softmax(torch.from_numpy(np.array(b, np.float32)), -1)
    return float(((pa * pb).sum(-1) / (pa.norm(dim=-1) * pb.norm(dim=-1))).min())


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_bf16_next_token_distribution_matches_jax(arch, nkv, attn_impl):
    r = _prefill_both(arch, nkv, attn_impl, dtype="bfloat16")
    assert r["tcache"].k.dtype == torch.bfloat16
    assert _softmax_cos(r["tlog"][:, -1].numpy(), r["jlog"][:, -1]) >= 0.999


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_greedy_generate_matches_jax(arch, nkv, attn_impl, kv_quant):
    """Greedy decode of a ragged batch, token for token and length for
    length, with an eos id taken from the undisturbed run so rows stop at
    different steps."""
    jcfg, tcfg = _cfgs(arch, nkv, attn_impl=attn_impl, kv_quant=kv_quant)
    jp, tp = _params(arch, nkv)
    ids, mask = _prompts(1)
    kw = dict(max_new_tokens=NEW, temperature=0.0, top_k=0)
    free, _ = jgpt.generate(jp, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0),
                            jcfg, **kw)
    free = np.asarray(free)
    assert len(np.unique(free)) > 2, free  # the weights keep decode moving
    eos = int(free[1, 2])
    want_t, want_n = jgpt.generate(jp, jnp.asarray(ids), jnp.asarray(mask),
                                   jax.random.key(0), jcfg, eos_id=eos, **kw)
    got_t, got_n = tgpt.generate(tp, _t(ids), _t(mask), torch.Generator().manual_seed(0),
                                 tcfg, eos_id=eos, **kw)
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))
    assert int(got_n[1]) <= 2  # row 1 met its eos


@pytest.mark.parametrize("arch,nkv", ARCHS)
def test_int8_cache_layout_and_bytes(arch, nkv):
    jcfg, tcfg = _cfgs(arch, nkv, kv_quant="int8")
    want = jgpt.init_cache(jcfg, 2, 10, jnp.float32)
    got = tgpt.init_cache(tcfg, 2, 10, torch.float32)
    assert isinstance(got, tgpt.QuantKVCache) and got.length == 0
    for w, g in zip(want[:4], got[:4]):
        assert tuple(w.shape) == tuple(g.shape) and str(w.dtype) == str(g.dtype).split(".")[1]
    assert tgpt.cache_bytes(got) == jgpt.cache_bytes(want)
    dense = tgpt.init_cache(dataclasses.replace(tcfg, kv_quant="none"), 2, 10, torch.bfloat16)
    assert tgpt.cache_bytes(dense) == 2 * 2 * 2 * 10 * tcfg.kv_heads * tcfg.head_dim * 2


def test_decode_chunks_continue_generate():
    """Prefill, then two decode chunks, give generate()'s tokens."""
    _, tcfg = _cfgs("llama", 2)
    _, tp = _params("llama", 2)
    ids, mask = _prompts(2)
    want, _ = tgpt.generate(tp, _t(ids), _t(mask), torch.Generator().manual_seed(5), tcfg,
                            max_new_tokens=NEW, temperature=0.9, top_k=7)
    gen = torch.Generator().manual_seed(5)
    cache, logits, kv_valid, plen = tgpt.prefill(tp, _t(ids), _t(mask), tcfg, NEW)
    done = torch.zeros(B, dtype=torch.bool)
    cache, logits, pos, done, a, _ = tgpt.decode_chunk(tp, cache, logits, plen, done, kv_valid,
                                                       gen, 2, tcfg, 0.9, 7)
    *_, b, _ = tgpt.decode_chunk(tp, cache, logits, pos, done, kv_valid, gen, NEW - 2, tcfg,
                                 0.9, 7)
    assert torch.equal(torch.cat([a, b], 1), want)


# ---------------------------------------------------------------- sampling


@pytest.mark.parametrize("top_k,vocab,bucket", [(0, 97, 0), (-3, 97, 0), (97, 97, 0),
                                                (200, 97, 0), (1, 97, 8), (8, 97, 8),
                                                (9, 97, 16), (40, 97, 64), (90, 97, 97)])
def test_top_k_bucket_matches_jax(top_k, vocab, bucket):
    assert tgpt._top_k_bucket(top_k, vocab) == jgpt._top_k_bucket(top_k, vocab) == bucket


def test_norm_sampling_matches_jax():
    for temp, k in ((0.7, 5), ([0.0, 1.0, 0.5], [3, 0, 12]), (1.0, 0)):
        jt, jk, jb = jgpt._norm_sampling(temp, k, 3, 97)
        tt, tk, tb = tgpt._norm_sampling(temp, k, 3, 97)
        assert tb == jb
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        assert np.array_equal(tk.numpy(), np.asarray(jk))


def test_top_k_cutoff_is_the_set_jax_samples_from():
    """Per row, the tokens the JAX sampler draws over 256 keys at a high
    temperature are exactly the tokens the port's cutoff keeps."""
    rng = np.random.default_rng(9)
    logits = rng.permutation(97 * 4).reshape(4, 97).astype(np.float32) / 50.0
    temp = np.full(4, 50.0, np.float32)
    top_k = np.array([1, 5, 11, 0])
    jt, jk, bucket = jgpt._norm_sampling(temp, top_k, 4, 97)
    drawn = [set() for _ in range(4)]
    for key in jax.random.split(jax.random.key(0), 256):
        for i, t in enumerate(np.asarray(jgpt._sample(jnp.asarray(logits), key, jt, jk, bucket))):
            drawn[i].add(int(t))
    tt, tk, tbucket = tgpt._norm_sampling(temp, top_k, 4, 97)
    kept = tgpt._top_k_cut(torch.from_numpy(logits) / tt[:, None], tk, tbucket)
    for i in range(3):
        assert drawn[i] == set(np.flatnonzero(np.isfinite(kept[i].numpy())).tolist())
    assert bool(torch.isfinite(kept[3]).all())  # top_k 0: no cutoff


def test_sample_greedy_rows_top_k_and_seed():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 3, (6, 97)).astype(np.float32))
    temp, k, bucket = tgpt._norm_sampling([0.0, 1.0, 1.0, 0.0, 2.0, 0.7], [0, 5, 20, 3, 1, 0],
                                          6, 97)
    draws = [tgpt._sample(logits, torch.Generator().manual_seed(s), temp, k, bucket)
             for s in range(40)]
    greedy = logits.argmax(-1)
    top = torch.topk(logits, 20, dim=-1).indices
    for d in draws:
        assert d[0] == greedy[0] and d[3] == greedy[3]  # temperature 0
        assert d[4] == greedy[4]  # top_k 1
        assert bool(torch.isin(d[1], top[1, :5])) and bool(torch.isin(d[2], top[2, :20]))
    assert len({int(d[5]) for d in draws}) > 1  # no cutoff, temperature 0.7: it samples
    again = tgpt._sample(logits, torch.Generator().manual_seed(7), temp, k, bucket)
    assert torch.equal(again, draws[7])


# ------------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def hf_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=97, n_embd=32, n_layer=2, n_head=4, n_positions=64)).eval()
    torch.manual_seed(1)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=64,
        tie_word_embeddings=False)).eval()
    return {"gpt2": gpt2, "llama": llama}


def _assert_trees_equal(got, want):
    flat_g, tree_g = jax.tree.flatten(got)
    flat_w, tree_w = jax.tree.flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_convert_gpt_matches_jax(hf_models, arch):
    model = hf_models[arch]
    hf_cfg = model.config.to_dict()
    cfg, jcfg = tgpt.GPTConfig.from_hf(hf_cfg), jgpt.GPTConfig.from_hf(hf_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = convert.convert_gpt(model.state_dict(), cfg)
    _assert_trees_equal(got, jconvert.convert_gpt(model.state_dict(), jcfg))
    assert ("lm_head" in got) == (arch == "llama") and len(got["layers"]) == 2


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_load_gpt_model_from_the_ports_safetensors(hf_models, arch, tmp_path, capsys):
    """A dir written by the port's own safetensors writer (bf16 tensors
    included) loads to the JAX converter's tree of the same state dict, and
    the CLI's gpt kind converts it."""
    model = hf_models[arch]
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    first = sorted(sd)[0]
    sd[first] = sd[first].to(torch.bfloat16)  # written as BF16, read back as float32
    convert.write_safetensors(tmp_path / "model.safetensors",
                              {k: (v if v.dtype == torch.bfloat16 else v.numpy())
                               for k, v in sd.items()})
    (tmp_path / "config.json").write_text(json.dumps(model.config.to_dict()))
    params, cfg = convert.load_gpt_model(tmp_path)
    jcfg = jgpt.GPTConfig.from_hf(model.config.to_dict())
    _assert_trees_equal(params, jconvert.convert_gpt({k: v.float() for k, v in sd.items()}, jcfg))
    convert.main([str(tmp_path)])
    assert "gpt: GPTConfig hidden=32 layers=2 heads=4" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_converted_checkpoint_forward_matches_transformers(hf_models, arch):
    """The converted tree through the port's forward gives the HF model's
    logits (float32, the bar of tests/test_gpt_numerics.py)."""
    model = hf_models[arch]
    cfg = dataclasses.replace(tgpt.GPTConfig.from_hf(model.config.to_dict()), dtype="float32")
    params = gpt_params_from_numpy(convert.convert_gpt(model.state_dict(), cfg), "cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 97, (2, 12)))
    with torch.no_grad():
        want = model(ids).logits.numpy()
    cache = tgpt.init_cache(cfg, 2, 12, torch.float32)
    got, _ = tgpt.forward(params, ids, cache, torch.arange(12).expand(2, 12), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
