"""The online LM fine-tune (`train/online.OnlineLmTrainer`) on both
packages, and the port's sync into the serving engine, on the CPU.

Every case of `tests/test_online_train.py` runs on the JAX package and on
the port (parametrised `[jax, torch]`) at its tiny llama (hidden 32, 2
layers, byte vocab), the port's engines with `force_cpu`. Then the port
against JAX: `_take_batches` packs the same tokens into the same batches
pass after pass; and the port's sync: no engine tensor shares storage with
a master, `update_params` keeps the engine's tensors, its prefill and
decode executables and its compile count (on the card: no new capture),
and after a sync the engine's greedy tokens equal a fresh engine's on the
masters; an int8 engine takes both codes and scales."""

import asyncio
import types

import numpy as np
import pytest
import torch

TINY = dict(enabled=True, arch="llama", hidden_size=32, num_layers=2,
            num_heads=4, intermediate_size=64, max_positions=128,
            dtype="float32", prompt_buckets=[8], new_token_buckets=[16],
            temperature=0.0)

CORPUS = ["the mesh shards batches across data parallel devices " * 4,
          "collectives ride the interconnect between the chips " * 4]


def _jax_pkg():
    import jax
    import jax.numpy as jnp

    from symbiont_tpu import config, runner, subjects
    from symbiont_tpu.bus.inproc import InprocBus
    from symbiont_tpu.engine import lm
    from symbiont_tpu.models import convert
    from symbiont_tpu.schema import RawTextMessage, to_json_bytes
    from symbiont_tpu.services.text_generator import TextGeneratorService
    from symbiont_tpu.train.online import OnlineLmTrainer
    from symbiont_tpu.utils import ids
    from symbiont_tpu.utils.telemetry import metrics

    def leaves(tree):
        """(float32 numpy or None for a non-float leaf, is float32 as held)."""
        out = []
        for a in jax.tree.leaves(tree):
            floating = jnp.issubdtype(a.dtype, jnp.floating)
            out.append((np.asarray(a, np.float32) if floating else None,
                        a.dtype == jnp.float32))
        return out

    return types.SimpleNamespace(
        name="jax", config=config, runner=runner, subjects=subjects, InprocBus=InprocBus,
        lm_mod=lm, convert=convert, RawTextMessage=RawTextMessage,
        to_json_bytes=to_json_bytes, TextGeneratorService=TextGeneratorService,
        OnlineLmTrainer=OnlineLmTrainer, ids=ids, metrics=metrics, leaves=leaves,
        cpu={}, engine_cpu={}, perturb=lambda tree, f: jax.tree.map(
            lambda a: (np.asarray(a, np.float32) * np.float32(f)
                       if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a)), tree))


def _torch_pkg():
    from symbiont_tpu_torch import config, runner, subjects
    from symbiont_tpu_torch.bus.inproc import InprocBus
    from symbiont_tpu_torch.engine import lm
    from symbiont_tpu_torch.models import convert, quant
    from symbiont_tpu_torch.schema import RawTextMessage, to_json_bytes
    from symbiont_tpu_torch.services.text_generator import TextGeneratorService
    from symbiont_tpu_torch.train.online import OnlineLmTrainer
    from symbiont_tpu_torch.utils import ids
    from symbiont_tpu_torch.utils.telemetry import metrics

    def leaves(tree):
        out = []
        for a in quant.leaves(tree):
            a = torch.as_tensor(a)
            floating = a.is_floating_point()
            out.append((a.detach().float().numpy() if floating else None,
                        a.dtype == torch.float32))
        return out

    return types.SimpleNamespace(
        name="torch", config=config, runner=runner, subjects=subjects, InprocBus=InprocBus,
        lm_mod=lm, convert=convert, RawTextMessage=RawTextMessage,
        to_json_bytes=to_json_bytes, TextGeneratorService=TextGeneratorService,
        OnlineLmTrainer=OnlineLmTrainer, ids=ids, metrics=metrics, leaves=leaves,
        cpu={"force_cpu": True}, engine_cpu={"force_cpu": True},
        perturb=lambda tree, f: quant.tree_map(
            lambda t: (t.detach().float().numpy() * np.float32(f) if t.is_floating_point()
                       else t.numpy()), tree))


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _jax_pkg() if request.param == "jax" else _torch_pkg()


def _lm(pkg, **kw):
    return pkg.lm_mod.LmEngine(pkg.config.LmConfig(**dict(TINY, **pkg.cpu, **kw)))


def test_generation_shifts_after_ingest_train(pkg):
    """Greedy generation changes after training on ingested text, and the
    LM loss on that text goes down."""
    lm = _lm(pkg)
    trainer = pkg.OnlineLmTrainer(lm, learning_rate=5e-3, seq_len=32, batch_size=4)
    before = lm.generate("the mesh", 16, temperature=0.0)
    first = trainer.train_on_texts(CORPUS, steps=1)
    for _ in range(6):
        last = trainer.train_on_texts(CORPUS, steps=4)
    assert last["loss"] < first["loss"], (first, last)
    after = lm.generate("the mesh", 16, temperature=0.0)
    assert after != before, "generation did not shift after ingest-train"
    assert trainer.stats["param_syncs"] >= 7


def test_serving_params_never_donated(pkg):
    """The serving engine keeps working across many train/generate
    interleavings (JAX: a donated buffer would raise on the second pass;
    the port: the masters are stepped in place and must not be the
    engine's)."""
    lm = _lm(pkg)
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2)
    for _ in range(3):
        trainer.train_on_texts(CORPUS, steps=1)
        assert isinstance(lm.generate("x", 8, temperature=0.0), str)


def test_train_state_persists_and_restores(pkg, tmp_path):
    """A restarted trainer resumes from the saved optimizer state (step
    count + params), and a model-shape mismatch starts fresh."""
    path = str(tmp_path / "lm_train")
    lm = _lm(pkg)
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2, state_path=path)
    out = trainer.train_on_texts(CORPUS, steps=3)
    steps_done = trainer.stats["train_steps"]
    assert steps_done == out["steps"] > 0

    lm2 = _lm(pkg)
    trainer2 = pkg.OnlineLmTrainer(lm2, seq_len=16, batch_size=2, state_path=path)
    assert trainer2.stats["train_steps"] == steps_done  # resumed, not reset
    # restored params flow into the new serving engine at once
    a = pkg.leaves({"wte": trainer.state.params["wte"]})[0][0]
    b = pkg.leaves({"wte": lm2.params["wte"]})[0][0]
    np.testing.assert_array_equal(a, b)

    # different geometry → fresh start
    lm3 = _lm(pkg, hidden_size=64, intermediate_size=128)
    trainer3 = pkg.OnlineLmTrainer(lm3, seq_len=16, batch_size=2, state_path=path)
    assert trainer3.stats["train_steps"] == 0


def test_pack_handles_empty_and_short_texts(pkg):
    lm = _lm(pkg)
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2)
    assert trainer.train_on_texts([""])["steps"] == 0  # nothing to learn
    out = trainer.train_on_texts(["ab"], steps=1)  # cycles to fill the batch
    assert out["steps"] == 1 and np.isfinite(out["loss"])


def test_long_text_carries_over_instead_of_dropping(pkg):
    """Text beyond one batch trains as more batches, and a sub-batch
    remainder carries over to the next pass."""
    lm = _lm(pkg)
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2)  # need = 32
    long_text = "every sentence the organism reads matters " * 12  # ~500 tok
    out = trainer.train_on_texts([long_text], steps=1)
    assert out["batches"] >= 3  # several batches, not one truncation
    total = out["batches"] * 32 + trainer.stats["tokens_pending"]
    assert total >= 500 * 0.9  # nearly every token accounted for
    if trainer.stats["tokens_pending"]:
        out2 = trainer.train_on_texts([], steps=1)
        assert out2["steps"] >= 1
        assert trainer.stats["tokens_pending"] == 0


def test_service_ingest_triggers_lm_training(pkg):
    """Raw-text messages buffer until the threshold, then a fine-tune pass
    runs and the serving engine's params move."""
    def raw(text):
        return pkg.to_json_bytes(pkg.RawTextMessage(
            id=pkg.ids.generate_uuid(), source_url="u", raw_text=text,
            timestamp_ms=pkg.ids.current_timestamp_ms()))

    async def scenario():
        lm = _lm(pkg)
        trainer = pkg.OnlineLmTrainer(lm, learning_rate=5e-3, seq_len=16, batch_size=2)
        wte_before = pkg.leaves({"w": lm.params["wte"]})[0][0].copy()
        bus = pkg.InprocBus()
        svc = pkg.TextGeneratorService(bus, lm_generate=lm.generate, train_on_ingest=False,
                                       lm_trainer=trainer, lm_train_min_chars=64,
                                       lm_train_steps=1)
        # the counter is process-wide: an earlier test may have raised it
        passes0 = pkg.metrics.snapshot()["counters"].get("text_generator.lm_train_passes", 0)
        await svc.start()
        try:
            await bus.publish(pkg.subjects.DATA_RAW_TEXT_DISCOVERED, raw("short"))
            await asyncio.sleep(0.2)
            assert trainer.stats["train_steps"] == 0  # below the threshold
            await bus.publish(pkg.subjects.DATA_RAW_TEXT_DISCOVERED, raw(CORPUS[0]))
            # the service counts the pass after the trainer has synced the
            # engine, so wait for the count, not for the trainer's steps
            for _ in range(1200):
                passes = pkg.metrics.snapshot()["counters"].get(
                    "text_generator.lm_train_passes", 0)
                if passes > passes0:
                    break
                await asyncio.sleep(0.05)
            assert trainer.stats["train_steps"] >= 1
            assert 1 <= trainer.stats["train_docs"] <= 2
            wte_after = pkg.leaves({"w": lm.params["wte"]})[0][0]
            assert not np.array_equal(wte_before, wte_after), \
                "serving engine params did not move after ingest training"
            snap = pkg.metrics.snapshot()["counters"]
            assert snap.get("text_generator.lm_train_passes", 0) >= 1
        finally:
            await svc.stop()

    asyncio.run(scenario())


def test_masters_init_from_precast_checkpoint(pkg, monkeypatch, tmp_path):
    """With the engine at bf16, a fresh trainer on a checkpoint takes its
    float32 masters from the pre-cast weights, not the engine's bf16
    copy; a saved train state still wins over the checkpoint."""
    base = _lm(pkg, dtype="bfloat16")
    # within one bf16 ulp of the engine's values: only a pre-cast load
    # reproduces them exactly
    ck_params = pkg.perturb(base.params, 1 + 1e-4)
    model_cfg = base.model_cfg
    calls = {"n": 0}

    def fake_load(model_dir):
        calls["n"] += 1
        return ck_params, model_cfg

    monkeypatch.setattr(pkg.convert, "load_gpt_model", fake_load)
    if hasattr(pkg.lm_mod, "load_gpt_model"):  # the port's engine imports it by name
        monkeypatch.setattr(pkg.lm_mod, "load_gpt_model", fake_load)

    lm = _lm(pkg, dtype="bfloat16", model_dir=str(tmp_path / "ck"))
    assert calls["n"] == 1  # the engine itself booted from the checkpoint
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2)
    assert calls["n"] == 2  # the trainer read the pre-cast weights again

    triples = [(c, m, e) for c, m, e in zip(pkg.leaves(ck_params),
                                            pkg.leaves(trainer.state.params),
                                            pkg.leaves(lm.params)) if c[0] is not None]
    assert triples
    for (ck, _), (master, is_f32), (engine, _) in triples:
        assert is_f32
        np.testing.assert_array_equal(master, ck)
    assert any(not np.array_equal(ck, engine) for (ck, _), _, (engine, _) in triples), \
        "checkpoint indistinguishable from bf16 params"

    state_path = str(tmp_path / "lm_train")
    saving = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2, state_path=state_path)
    saving.train_on_texts(CORPUS, steps=1)
    steps = saving.stats["train_steps"]
    calls_before = calls["n"]
    resumed = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2, state_path=state_path)
    assert resumed.stats["train_steps"] == steps
    assert calls["n"] == calls_before  # a resume never reads the checkpoint


def test_masters_fall_back_to_engine_params_on_load_failure(pkg, monkeypatch, tmp_path):
    """A vanished checkpoint dir degrades to the widened engine params."""
    lm = _lm(pkg, dtype="bfloat16")
    lm.config.model_dir = str(tmp_path / "gone")

    def boom(model_dir):
        raise FileNotFoundError(model_dir)

    monkeypatch.setattr(pkg.convert, "load_gpt_model", boom)
    trainer = pkg.OnlineLmTrainer(lm, seq_len=16, batch_size=2)
    for (a, _), (b, _) in zip(pkg.leaves(trainer.state.params), pkg.leaves(lm.params)):
        if b is not None:
            np.testing.assert_array_equal(a, b)


def test_runner_wires_trainer_when_enabled(pkg, tmp_path):
    """SymbiontStack builds the OnlineLmTrainer from LmConfig.ingest_train
    and hands it to the text generator service."""
    c = pkg.config
    cfg = c.SymbiontConfig(
        engine=c.EngineConfig(embedding_dim=32, length_buckets=[16], batch_buckets=[2],
                              max_batch=2, dtype="float32", data_parallel=False,
                              **pkg.engine_cpu),
        lm=c.LmConfig(**dict(TINY, **pkg.cpu, ingest_train=True, ingest_train_seq_len=16,
                             ingest_train_batch=2,
                             train_state_path=str(tmp_path / "lm_train"))),
        vector_store=c.VectorStoreConfig(dim=32, data_dir=str(tmp_path / "vs")),
        graph_store=c.GraphStoreConfig(data_dir=str(tmp_path / "gs")),
        text_generator=c.TextGeneratorConfig(markov_state_path=str(tmp_path / "markov.json")),
        api=c.ApiConfig(host="127.0.0.1", port=0))

    async def scenario():
        stack = pkg.runner.SymbiontStack(cfg, bus=pkg.InprocBus())
        await stack.start()
        try:
            svc = next(s for s in stack.services if s.name == "text_generator")
            assert svc.lm_trainer is not None
            assert svc.lm_trainer.lm is stack.lm
        finally:
            await stack.stop()

    asyncio.run(scenario())


# ------------------------------------------------- the port against JAX


def test_take_batches_match_jax_token_for_token():
    """The same texts pack into the same [B, S] batches on both packages,
    pass after pass: full batches, the carried remainder, the cycled short
    stream, the backlog cap (tokens dropped oldest first)."""
    jx, pt = _jax_pkg(), _torch_pkg()
    tj = jx.OnlineLmTrainer(_lm(jx), seq_len=16, batch_size=2)
    tt = pt.OnlineLmTrainer(_lm(pt), seq_len=16, batch_size=2)
    for cls in (type(tj), type(tt)):
        assert (cls.MAX_BATCHES_PER_PASS, cls.MAX_PENDING_BATCHES, cls._DOC_TOKEN_CAP) == (
            16, 64, 1 << 18)
    rng = np.random.default_rng(0)
    words = ["mesh", "chip", "ring", "shard", "ünïcode", "ok"]
    passes = [[" ".join(rng.choice(words, int(n))) for n in rng.integers(1, 40, 3)],
              ["ab"], [], ["x" * 900], [" ".join(rng.choice(words, 1200))], [""]]
    for texts in passes:
        a, b = tj._take_batches(texts), tt._take_batches(texts)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for k in ("ids", "mask"):
                np.testing.assert_array_equal(np.asarray(x[k]), y[k].numpy())
        assert tj.stats == tt.stats and tj._stream == tt._stream


def _port_lm(**kw):
    pt = _torch_pkg()
    return pt, _lm(pt, **kw)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_no_engine_tensor_shares_storage_with_a_master(quantize):
    pt, lm = _port_lm(quantize=quantize)
    trainer = pt.OnlineLmTrainer(lm, learning_rate=5e-3, seq_len=16, batch_size=2)

    def storages(tree):
        out = set()
        for a in pt.lm_mod.quant.leaves(tree):
            for t in ((a.q, a.scale) if pt.lm_mod.quant.is_quantized(a) else (a,)):
                out.add(t.untyped_storage().data_ptr())
        return out

    for _ in range(2):  # at construction, and after a pass and its sync
        assert not storages(lm.params) & storages(trainer.state.params)
        trainer.train_on_texts(CORPUS, steps=1)


def _lm_compiles(pt) -> int:
    return sum(r["compiles"] for r in pt.lm_mod.dispatch_ledger.snapshot()
               if r["executable"].startswith("lm."))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_sync_keeps_the_engines_tensors_and_executables(quantize, dtype):
    """After a pass: the engine's tensors (an int8 leaf's codes and scales)
    are the ones it held, each now the placed masters' values; the prefill
    executable and the decode carrier's executable are the same objects and
    nothing compiled again; the greedy tokens of a prompt equal a fresh
    engine's on the masters, and differ from the tokens before. At float32
    and at bfloat16, `LmConfig`'s default: a bf16 engine trains a bf16
    forward and backward on float32 masters and syncs them cast."""
    pt, lm = _port_lm(quantize=quantize, dtype=dtype)
    quant = pt.lm_mod.quant
    trainer = pt.OnlineLmTrainer(lm, learning_rate=5e-3, seq_len=16, batch_size=2)
    before = lm.generate("the mesh", 16)
    prefills = dict(lm._prefills.items())
    (carrier,) = lm._free_carriers.values()
    decodes = dict(carrier.exes)
    held = [(t.q, t.scale) if quant.is_quantized(t) else (t,) for t in quant.leaves(lm.params)]
    compiles = _lm_compiles(pt)
    for _ in range(3):
        trainer.train_on_texts(CORPUS, steps=2)
    after = lm.generate("the mesh", 16)
    assert dict(lm._prefills.items()) == prefills and dict(carrier.exes) == decodes
    assert _lm_compiles(pt) == compiles
    now = [(t.q, t.scale) if quant.is_quantized(t) else (t,) for t in quant.leaves(lm.params)]
    assert all(a is b for x, y in zip(held, now) for a, b in zip(x, y))
    want = lm._place_params(quant.tree_map(lambda t: t.detach().clone(), trainer.state.params))
    for have, placed in zip(quant.leaves(lm.params), quant.leaves(want)):
        for a, b in ((have.q, placed.q), (have.scale, placed.scale)) if quant.is_quantized(
                have) else ((have, placed),):
            assert torch.equal(a, b)
    fresh = pt.lm_mod.LmEngine(
        pt.config.LmConfig(**dict(TINY, **pt.cpu, quantize=quantize, dtype=dtype)),
        params=quant.tree_map(lambda t: t.detach().clone(), trainer.state.params),
        model_cfg=lm.model_cfg)
    assert after == fresh.generate("the mesh", 16) and after != before


def test_update_params_refuses_another_geometry():
    pt, lm = _port_lm()
    other = _lm(pt, hidden_size=64, intermediate_size=128)
    with pytest.raises(ValueError, match="does not fit"):
        lm.update_params(other.params)


def test_update_params_pairs_leaves_by_key_not_by_dict_order():
    """A tree whose dicts list their keys in another order (a bridge tree
    from JAX lists them sorted) lands leaf by leaf on the same names: the
    tiny llama's q, k and v kernels share one shape, so a pairing by
    position would swap them unseen."""
    pt, lm = _port_lm()
    quant = pt.lm_mod.quant
    gen = torch.Generator().manual_seed(3)
    new = quant.tree_map(lambda t: torch.randn(t.shape, generator=gen), lm.params)

    def reordered(tree):
        if isinstance(tree, dict):
            return {k: reordered(tree[k]) for k in reversed(list(tree))}
        if isinstance(tree, (list, tuple)):
            return [reordered(v) for v in tree]
        return tree

    lm.update_params(reordered(new))
    for have, want in zip(quant.leaves(lm.params), quant.leaves(new)):
        assert torch.equal(have, want)
