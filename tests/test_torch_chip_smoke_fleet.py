"""chip_smoke.py's `[fleet]` phase rehearsed on the CPU at tiny geometries
(a 64-wide, 6-layer synthetic encoder in the embed role, a 2-layer GPT-2
dir in both generation roles), with every check it makes on the card: the
supervised broker, gateway, perception, memory and graphgen processes, a
stitched trace over 3 processes, the role-labelled surfaces, a scale-in
drain, and the durable-generation deployment whose gen1 is SIGKILLed after
its streams' second chunk. The CPU path launches no kernel, so B1's plain
forwards are counted as its launches and both launch equations are held on
them. Plus: a failing `[fleet]` check fails the whole run."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import TINY_GPT2, TINY_STACK_ENGINE

TINY_FLEET = dict(pages=4, sentences=4, queries=4, top_k=3, gen=4, gen_new=32, chunk=2,
                  gen_bucket=(8, 16), timeout_s=90.0)
TINY_FLEET_LM = dict(force_cpu=True, prompt_buckets=[8, 16, 32, 64],
                     new_token_buckets=[4, 16, 32])


def test_fleet_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    from symbiont_tpu_torch.models import gpt as gpt_mod
    from symbiont_tpu_torch.ops import flash_attention as fa

    params = gpt_mod.init_params(torch.Generator().manual_seed(4),
                                 gpt_mod.GPTConfig.from_hf(dict(TINY_GPT2, n_positions=256)))
    chip_smoke.write_gpt_checkpoint(tmp_path / "gpt2", params, dict(TINY_GPT2, n_positions=256),
                                    torch.float32)
    forward = fa._forward

    def counted(*a, **kw):
        with fa._count_lock:
            fa.launches += 1
        return forward(*a, **kw)

    monkeypatch.setattr(fa, "_forward", counted)
    out = chip_smoke.fleet_phase(np.random.default_rng(0), tmp_path, sizes=TINY_FLEET,
                                 device="cpu", engine_kw=TINY_STACK_ENGINE, lm_kw=TINY_FLEET_LM)
    printed = capsys.readouterr().out
    assert printed.count("[fleet] (cpu)") == 5  # the first and the last search's spans apart
    # B1 against plain at each GPT-2 bucket a stream or a resume prefills
    assert printed.count("[fleet] flash_attn_fwd causal q[1, 4, ") >= 2
    search, durable = out["search"], out["durable"]
    assert search["ingest"]["sentences"] == 16 and search["graph_documents"] == 4
    assert search["search"]["queries"] == 4 and search["search"]["fallbacks"] == 0
    assert search["trace_processes"] >= 3
    for key in ("first_search_hops", "search_hops"):
        assert {"api.search", "vector_memory.search", "engine.rerank"} <= {
            name for name, *_ in search[key]}
    se = search["search"]
    assert se["first_ms"] <= se["max_ms"] and se["p50_ms"] <= se["max_ms"]
    assert {"gateway", "perception", "embed", "memory", "graphgen"} <= set(search["roles"])
    assert search["drain"]["clean"] and search["drain"]["replica"] == "perception-2"
    assert durable["streams"] == 4 and durable["resumed"] >= 1
    assert durable["held_by_gen1"] >= durable["resumed"]
    assert durable["kill_to_first_replayed_delta_ms"] > 0
    assert len(durable["resume_prefill_ms"]) == durable["resumed"]
    # 6 encoder layers: embed batches and rerank batches; 2 GPT-2 layers:
    # gen2's stream prefills and resume re-prefills
    m = re.match(r"(\d+) = 6 x \((\d+) embed batches \+ 0 fused queries \+ (\d+) rerank",
                 search["b1"]["equation"])
    assert m and int(m[1]) == 6 * (int(m[2]) + int(m[3])) and int(m[3]) >= 4
    m = re.match(r"(\d+) = 2 x \((\d+) stream prefills \+ (\d+) resume re-prefills\)",
                 durable["b1"]["equation"])
    assert m and int(m[1]) == 2 * (int(m[2]) + int(m[3])) and int(m[3]) == durable["resumed"]
    assert out["launches"] == search["b1"]["launches"] + durable["b1"]["launches"]


def test_a_failing_fleet_check_fails_the_run(monkeypatch, capsys):
    """Every phase before [fleet] stubbed to pass; a stream whose SSE seq
    has a gap fails [fleet], which leaves main() by its exception and
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
                 sp_phase=lambda rng: {"launches": (0, 0, 0)},
                 stack_phase=lambda rng, tmp, serve: {"launches": 0},
                 fleet_phase=lambda rng, tmp: chip_smoke.check(
                     False, "[fleet] fleet-gen-1: SSE seq [0, 2, 3] has a gap or a duplicate"))
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    with pytest.raises(RuntimeError, match="has a gap"):
        chip_smoke.main()
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("tree,n", [
    ({"roots": [{"name": "api.search", "fields": {}, "children": [
        {"name": "preprocessing.handle", "fields": {"role": "embed", "pid": 7}, "children": []},
        {"name": "engine.rerank", "fields": {"role": "embed", "pid": 7}, "children": []},
        {"name": "vector_memory.search", "fields": {"role": "memory", "pid": 9},
         "children": []}]}]}, 3),
    ({"roots": [{"name": "api.search", "fields": {}, "children": []}]}, 1),
    ({}, 0),
])
def test_trace_processes_counts_processes(tree, n):
    """The gateway's own spans, and one process per pid the remote spans
    carry."""
    assert chip_smoke.trace_processes(tree) == n


def test_config_env_and_journal_tokens(tmp_path):
    assert chip_smoke.config_env("lm", {"enabled": True, "prompt_buckets": [8, 16],
                                        "dtype": "float32", "stream_chunk": 16}) == {
        "SYMBIONT_LM_ENABLED": "1", "SYMBIONT_LM_PROMPT_BUCKETS": "[8, 16]",
        "SYMBIONT_LM_DTYPE": "float32", "SYMBIONT_LM_STREAM_CHUNK": "16"}
    (tmp_path / "gen1.genlog.orphaned").write_text(
        '{"task_id": "a", "tokens": [1, 2]}\n{"task_id": "b", "tokens": [5]}\n')
    (tmp_path / "gen2.genlog").write_text(
        '{"task_id": "a", "tokens": [1, 2, 3, 4]}\n{"task_id": "a", "done": true}\n'
        '{"task_id": "c", "tok')
    assert chip_smoke.journal_tokens(tmp_path) == {"a": [1, 2, 3, 4], "b": [5]}
