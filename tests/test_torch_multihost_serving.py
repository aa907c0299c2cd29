"""A15 multi-host serving on the port: the serving paths the JAX package
can run across processes (their outputs replicated), driven in lockstep
as a multi-controller JAX program runs.

Two processes (this file run as a script, one per "host") join one gloo
world on a localhost coordinator, one CPU entry each, build the same
meshes in the same order and make the same calls with the same arguments:

- the LM (`tests/test_torch_multihost.py`'s llama `MODEL`: 2 layers, 4
  heads over 2 KV heads, its tied vocab widened to 258 so the byte
  tokenizer's ids fit and it still splits, 128 positions, kernels x8 so
  greedy text moves) on a [1, 2] mesh whose 'tensor' axis pairs process
  0's entry with process 1's: dense, int8 KV and paged (radix on)
  `generate_batch`, a stream, sessions, a full radix hit, a self-drafted
  speculative session and one pass of the online fine-tune with its sync;
- a row-split `VectorStore` and a `TorchEngine`'s fused query (a tiny
  BERT) on [2, 1] over the same two entries.

Bars: the two processes' greedy float32 tokens, page tables, pool stats
and hits are bit-equal; the tokens equal the port's one-process TP engine
on [1, 2] over two CPU entries and JAX's `LmEngine` on the same tree; the
hits equal the one-process store's and JAX's `VectorStore.search` /
`search_fused`; the online loss is within rtol 1e-4 of JAX's one-device
step. What the JAX package cannot serve across processes raises in both
processes with its reason. The workers import no JAX; the parent writes
their inputs from numpy seeds and runs the JAX side while they run.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# tests/test_torch_multihost.py's MODEL, the vocab and positions widened
MODEL = dict(vocab_size=258, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             max_position_embeddings=128, arch="llama", num_kv_heads=2, dtype="float32",
             tie_word_embeddings=True)
LM = dict(enabled=True, dtype="float32", prompt_buckets=[16, 32], new_token_buckets=[32],
          kv_page_tokens=8, stream_chunk=4, session_min_rows=4, gen_max_batch=4,
          temperature=0.0, spec_k=4)
PROMPTS = ["the quick brown fox", "mesh across processes", "x"]
DOC = ["two processes hold one tensor line and sum their shards in lockstep " * 3]
BERT = dict(vocab_size=500, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            max_position_embeddings=32, dtype="float32")
ENG_KW = dict(embedding_dim=32, length_buckets=[8, 16], batch_buckets=[8, 16], max_batch=16,
              dtype="float32")
DOCS = [f"document about topic {i} and detail {i % 7}" for i in range(40)]
QUERIES = ["topic detail", "document about seven", "detail 3"]
N_ROWS, DIM, BLOCK = 300, 32, 64
WORKER_TIMEOUT_S = 120
REFUSED = {  # what stays refused across processes → the reason its message names
    "TorchEngine.embed_texts": "JAX's fetch", "TorchEngine.rerank": "JAX's fetch",
    "TorchEngine.warmup": "JAX's fetch", "save_train_state": "JAX's fetch",
    "save_params": "JAX's fetch", "OnlineLmTrainer(state_path)": "JAX's fetch",
    "GenBatcher": "no lockstep request feed", "runner": "no lockstep request feed",
    "mesh_from_config": "no lockstep request feed",
}


class IdTok:
    """Bytes in (BOS 256), every id out as its number in brackets: text
    equality is token equality."""

    bos_id = pad_id = 256

    def encode(self, text: str, max_len: int) -> list:
        return ([self.bos_id] + list(text.encode("utf-8")))[:max_len]

    def decode(self, ids) -> str:
        return "".join(f"[{int(i)}]" for i in ids)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flatten(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for j, x in enumerate(tree) for k, v in _flatten(x, f"{prefix}{j}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _unflatten(flat) -> dict:
    root: dict = {}
    for key in flat:
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = flat[key]

    def lists(x):
        if not isinstance(x, dict):
            return x
        if x and all(k.isdigit() for k in x):
            return [lists(x[str(j)]) for j in range(len(x))]
        return {k: lists(v) for k, v in x.items()}

    return lists(root)


def _load(path) -> dict:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def _jsonable(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------- one run, any engine


def _drain(sess, trace=None) -> dict:
    out = {}
    while not sess.done():
        out.update(sess.step())
        if trace is not None:  # the host page table and the allocator after each chunk
            pool = sess.lm.pool
            trace.append([sess._pt.tolist(), list(pool._free), list(pool._refcount)])
    return out


def _prefix_session(eng, trace=None) -> list:
    """A cold start, then a session whose mid-decode admission shares its
    first page with the committed prompt → (outputs, radix stats, pages
    live and free after)."""
    first = _drain(eng.start_session(["shared prefix pages and a tail", "another row"],
                                     [10, 10]), trace)
    sess = eng.start_session(["shared prefix pages and a tail"], [12])
    out = dict(sess.step())
    assert None not in sess.admit(["shared prefix pages but a fork"], [8])
    out.update(_drain(sess, trace))
    hit = _drain(eng.start_session(["shared prefix pages and a tail"], [6]), trace)
    return [first, out, hit, dict(eng.radix.stats), eng.pool.pages_live, eng.pool.pages_free]


def lm_outputs(make, trace=None) -> dict:
    """The serving calls of the LM half, in one order, on engines from
    `make(**lm_kw)` (`draft=True`: the engine drafts for itself). The
    same function runs in each worker, on the one-process TP engine and
    on JAX's engine."""
    out = {}
    dense = make()
    out["dense"] = dense.generate_batch(PROMPTS, [12] * 3)
    out["stream"] = "".join(dense.generate_stream("a stream over two processes", 12))
    out["session_one_chunk"] = _drain(dense.start_session(PROMPTS, [4] * 3))
    sess = dense.start_session(PROMPTS[:2], [12, 12])
    got = dict(sess.step())
    assert None not in sess.admit(["a row admitted mid-decode"], [6])
    got.update(_drain(sess))
    out["session"] = got
    out["int8"] = make(kv_quant="int8").generate_batch(PROMPTS, [12] * 3)
    paged = make(kv_layout="paged")
    out["paged"] = paged.generate_batch(PROMPTS, [12] * 3)
    out["radix"] = _prefix_session(paged, trace)
    spec = make(draft=True)
    out["spec"] = _drain(spec.start_session(PROMPTS[:2], [16, 16]))
    out["spec_stream"] = "".join(spec.generate_stream("a drafted stream", 12))
    out["spec_counts"] = [spec._spec_proposed, spec._spec_accepted]
    return _jsonable(out)


def sampled_outputs(make) -> dict:
    """The LM calls at `LmConfig`'s default sampling (its temperature and
    top_k), on fresh engines from one seed: dense and paged (radix on),
    each a batch, a stream and a session with a mid-decode admission, and
    a self-drafted speculative session. The draws follow the engine's host
    seed sequence, so the port's two processes and its one-process TP
    engine draw alike; JAX draws from its own PRNG and is not compared."""
    from symbiont_tpu_torch.config import LmConfig

    default = LmConfig()
    sampling = dict(temperature=default.temperature, top_k=default.top_k)
    assert sampling["temperature"] > 0.0
    out = {}
    for name, kw in (("dense", {}), ("paged", {"kv_layout": "paged"})):
        eng = make(**sampling, **kw)
        out[f"{name}_batch"] = eng.generate_batch(PROMPTS, [12] * 3)
        out[f"{name}_stream"] = "".join(eng.generate_stream("a sampled stream", 12))
        sess = eng.start_session(PROMPTS[:2], [12, 12])
        got = dict(sess.step())
        assert None not in sess.admit(["a sampled row admitted mid-decode"], [6])
        got.update(_drain(sess))
        out[f"{name}_session"] = got
        if name == "paged":
            out["paged_pool"] = [dict(eng.radix.stats), eng.pool.pages_live,
                                 eng.pool.pages_free]
    spec = make(draft=True, **sampling)
    out["spec"] = _drain(spec.start_session(PROMPTS[:2], [16, 16]))
    out["spec_counts"] = [spec._spec_proposed, spec._spec_accepted]
    return _jsonable(out)


def online_outputs(make, trainer_cls) -> dict:
    """One online pass over `DOC` on a fresh dense engine, its sync, and
    the greedy tokens after it."""
    eng = make()
    loss = trainer_cls(eng, seq_len=32, batch_size=4).train_on_texts(DOC)["loss"]
    return {"loss": float(loss), "after": eng.generate_batch(PROMPTS[:2], [10, 10])}


def _hits(hs) -> list:
    return [[h.id, h.score] for h in hs]


def store_outputs(store_cls, cfg_cls, mesh_kw: dict, rows: dict, engine) -> dict:
    """The row-split store's searches and the fused queries: the same
    rows upserted in one order, then each query."""
    vs = store_cls(cfg_cls(dim=DIM, data_dir="", shard_capacity=BLOCK), **mesh_kw)
    vs.upsert_rows(rows["ids"], rows["vecs"], [{"i": i} for i in range(N_ROWS)])
    fused = store_cls(cfg_cls(dim=DIM, data_dir="", shard_capacity=BLOCK), **mesh_kw)
    fused.upsert_rows([f"d{i}" for i in range(len(DOCS))], rows["doc_vecs"],
                      [{"t": t} for t in DOCS])
    return {"search": [_hits(vs.search(q, 7)) for q in rows["queries"]],
            "fused": [_hits(fused.search_fused(engine, q, 5)) for q in QUERIES]}


# ------------------------------------------------------------------ worker


def _refusals(lm_mesh, store_mesh, tree, bert, tmp) -> dict:
    """Each path that stays refused across processes → its message."""
    from symbiont_tpu_torch import runner
    from symbiont_tpu_torch.config import (EngineConfig, LmConfig, ParallelConfig,
                                           SymbiontConfig)
    from symbiont_tpu_torch.engine.batcher import GenBatcher
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.models import bert as tbert
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.models.bridge import bert_params_from_numpy, gpt_params_from_numpy
    from symbiont_tpu_torch.parallel import mesh as mesh_mod
    from symbiont_tpu_torch.train import checkpoint, trainer
    from symbiont_tpu_torch.train.online import OnlineLmTrainer

    cfg = tgpt.GPTConfig(**MODEL)
    lm = LmEngine(LmConfig(**LM), params=gpt_params_from_numpy(tree, "cpu"), model_cfg=cfg,
                  tokenizer=IdTok(), mesh=lm_mesh, device="cpu")
    state, tx = trainer.make_lm_train_state(gpt_params_from_numpy(tree, "cpu"))
    state, _ = trainer.shard_lm_train_state(lm_mesh, state, tx, arch="llama")
    eng = TorchEngine(EngineConfig(**ENG_KW, rerank_enabled=True),
                      params=bert_params_from_numpy(bert, "cpu"),
                      model_cfg=tbert.BertConfig(**BERT), mesh=store_mesh, device="cpu")
    tries = {
        "TorchEngine.embed_texts": lambda: eng.embed_texts(DOCS[:3]),
        "TorchEngine.rerank": lambda: eng.rerank("a query", DOCS[:3]),
        "TorchEngine.warmup": lambda: eng.warmup(),
        "save_train_state": lambda: checkpoint.save_train_state(tmp / "state", state),
        "save_params": lambda: checkpoint.save_params(tmp / "params", lm.params),
        "OnlineLmTrainer(state_path)": lambda: OnlineLmTrainer(lm, state_path=str(tmp / "s")),
        "GenBatcher": lambda: GenBatcher(lm),
        "runner": lambda: runner._refuse_unported(SymbiontConfig(), store_mesh, False),
        "mesh_from_config": lambda: mesh_mod.mesh_from_config(
            ParallelConfig(mesh_shape=[2, 1]), cpu=True),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _worker(tmp: str) -> int:
    """One process of the two: join the world, serve every call, write
    `report_<rank>.json`."""
    assert "jax" not in sys.modules, "the port's worker must not import JAX"
    from symbiont_tpu_torch.config import EngineConfig, LmConfig, VectorStoreConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
    from symbiont_tpu_torch.memory.vector_store import VectorStore
    from symbiont_tpu_torch.models import bert as tbert
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.models.bridge import bert_params_from_numpy, gpt_params_from_numpy
    from symbiont_tpu_torch.parallel import build_mesh, init_distributed
    from symbiont_tpu_torch.parallel import mesh as mesh_mod
    from symbiont_tpu_torch.parallel.sharding import Sharded
    from symbiont_tpu_torch.train.online import OnlineLmTrainer
    from symbiont_tpu_torch.train.trainer import tree_leaves

    tmp = Path(tmp)
    torch.manual_seed(0)
    init_distributed(devices=[CPU])
    rank = mesh_mod.process_index()
    tree, bert = _load(tmp / "lm.npz"), _load(tmp / "bert.npz")
    with np.load(tmp / "rows.npz") as z:
        rows = {k: z[k] for k in z.files}
    rows["ids"] = [f"p{i}" for i in range(N_ROWS)]
    lm_mesh, store_mesh = build_mesh([1, 2]), build_mesh([2, 1])
    cfg = tgpt.GPTConfig(**MODEL)
    engines = []

    def make(draft=False, **kw):
        extra = {} if not draft else dict(draft_params=gpt_params_from_numpy(tree, "cpu"),
                                          draft_model_cfg=cfg)
        eng = LmEngine(LmConfig(**{**LM, **kw}), params=gpt_params_from_numpy(tree, "cpu"),
                       model_cfg=cfg, tokenizer=IdTok(), mesh=lm_mesh, device="cpu", **extra)
        engines.append(eng)
        return eng

    trace: list = []
    t0 = time.perf_counter()
    report = {"rank": rank, "spans": [lm_mesh.spans_processes, store_mesh.spans_processes],
              "lm": lm_outputs(make, trace), "page_trace": trace}
    report["lm_s"] = time.perf_counter() - t0
    q = engines[0].params["layers"][0]["q"]["kernel"]
    paged = engines[2]
    report["layout"] = {"q": [list(q.spec), sum(t is not None for t in q.shards)],
                        "pool_shards": len(paged.pool.shards),
                        "pool_heads": int(paged.pool.shards[0][0].shape[3]),
                        "drafter_whole": not any(isinstance(x, Sharded) for x in
                                                 tree_leaves(engines[3]._draft[0]))}
    report["sampled"] = sampled_outputs(make)
    report["online"] = online_outputs(make, OnlineLmTrainer)
    eng = TorchEngine(EngineConfig(**ENG_KW), params=bert_params_from_numpy(bert, "cpu"),
                      model_cfg=tbert.BertConfig(**BERT), tokenizer=HashTokenizer(500),
                      mesh=store_mesh, device="cpu")
    report["store"] = store_outputs(VectorStore, VectorStoreConfig,
                                    {"device": "cpu", "mesh": store_mesh}, rows, eng)
    report["refusals"] = _refusals(lm_mesh, store_mesh, tree, bert, tmp / f"r{rank}")
    report["seconds"] = time.perf_counter() - t0
    (tmp / f"report_{rank}.json").write_text(json.dumps(report))
    mesh_mod.shutdown_distributed()
    if rank == 0:  # out of the world: the one-process port on two CPU entries
        (tmp / "one.json").write_text(json.dumps(_one_process(tmp)))
    return 0


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_side(tmp: Path):
    """JAX's tree, BERT and rows written for the workers; then JAX's
    outputs of every call."""
    import jax

    from symbiont_tpu.config import EngineConfig as JaxEngineConfig
    from symbiont_tpu.config import LmConfig as JaxLmConfig
    from symbiont_tpu.config import VectorStoreConfig as JaxStoreConfig
    from symbiont_tpu.engine.engine import TpuEngine
    from symbiont_tpu.engine.lm import LmEngine as JaxLmEngine
    from symbiont_tpu.engine.tokenizer import HashTokenizer as JaxHashTokenizer
    from symbiont_tpu.memory.vector_store import VectorStore as JaxStore
    from symbiont_tpu.models import bert as jbert
    from symbiont_tpu.models import gpt as jgpt
    from symbiont_tpu.train.online import OnlineLmTrainer as JaxOnlineLmTrainer

    jcfg = jgpt.GPTConfig(**MODEL)
    tree = jax.tree.map(lambda a: np.asarray(a) * (8 if np.ndim(a) >= 2 else 1),
                        jgpt.init_params(jax.random.key(4), jcfg))
    np.savez(tmp / "lm.npz", **_flatten(tree))
    bcfg = jbert.BertConfig(**BERT)
    bert = jax.tree.map(np.asarray, jbert.init_params(jax.random.key(0), bcfg))
    np.savez(tmp / "bert.npz", **_flatten(bert))
    jeng = TpuEngine(JaxEngineConfig(**ENG_KW), params=jax.tree.map(jax.numpy.asarray, bert),
                     model_cfg=bcfg, tokenizer=JaxHashTokenizer(500))
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    vecs[BLOCK + 40] = vecs[3]  # a tie across two shards: the lower row first
    rows = {"vecs": vecs, "queries": np.concatenate([rng.standard_normal((4, DIM)), vecs[3:4]])
            .astype(np.float32), "doc_vecs": jeng.embed_texts(DOCS)}
    np.savez(tmp / "rows.npz", **rows)
    rows["ids"] = [f"p{i}" for i in range(N_ROWS)]

    def make(draft=False, **kw):
        extra = {} if not draft else dict(draft_params=tree, draft_model_cfg=jcfg)
        return JaxLmEngine(JaxLmConfig(**{**LM, **kw}), params=tree, model_cfg=jcfg,
                           tokenizer=IdTok(), **extra)

    yield  # the inputs are written: the workers start
    out = {"lm": lm_outputs(make), "online": online_outputs(make, JaxOnlineLmTrainer),
           "store": _jsonable(store_outputs(JaxStore, JaxStoreConfig, {}, rows, jeng))}
    yield out


def _one_process(tmp: Path) -> dict:
    """The port's one-process TP engine, store and fused engine on two CPU
    entries, on the workers' inputs (worker 0 runs it once it has left the
    world)."""
    from symbiont_tpu_torch.config import EngineConfig, LmConfig, VectorStoreConfig
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.engine.tokenizer import HashTokenizer
    from symbiont_tpu_torch.memory.vector_store import VectorStore
    from symbiont_tpu_torch.models import bert as tbert
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.models.bridge import bert_params_from_numpy, gpt_params_from_numpy
    from symbiont_tpu_torch.parallel import build_mesh
    from symbiont_tpu_torch.train.online import OnlineLmTrainer

    tree, bert = _load(tmp / "lm.npz"), _load(tmp / "bert.npz")
    with np.load(tmp / "rows.npz") as z:
        rows = {k: z[k] for k in z.files}
    rows["ids"] = [f"p{i}" for i in range(N_ROWS)]
    cfg = tgpt.GPTConfig(**MODEL)

    def make(draft=False, **kw):
        extra = {} if not draft else dict(draft_params=gpt_params_from_numpy(tree, "cpu"),
                                          draft_model_cfg=cfg)
        return LmEngine(LmConfig(**{**LM, **kw}), params=gpt_params_from_numpy(tree, "cpu"),
                        model_cfg=cfg, tokenizer=IdTok(),
                        mesh=build_mesh([1, 2], devices=[CPU] * 2), device="cpu", **extra)

    trace: list = []
    mesh = build_mesh([2, 1], devices=[CPU] * 2)
    assert not mesh.spans_processes
    eng = TorchEngine(EngineConfig(**ENG_KW), params=bert_params_from_numpy(bert, "cpu"),
                      model_cfg=tbert.BertConfig(**BERT), tokenizer=HashTokenizer(500),
                      mesh=mesh, device="cpu")
    return {"lm": lm_outputs(make, trace), "page_trace": trace,
            "sampled": sampled_outputs(make), "online": online_outputs(make, OnlineLmTrainer),
            "store": store_outputs(VectorStore, VectorStoreConfig,
                                   {"device": "cpu", "mesh": mesh}, rows, eng)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the inputs, start the two workers, run JAX's side while they
    run → (reports by rank, JAX's outputs, the one-process port's, the
    workers' wall seconds)."""
    tmp = tmp_path_factory.mktemp("multihost_serving")
    jax_side = _jax_side(tmp)
    next(jax_side)
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   SYMBIONT_COORDINATOR=f"127.0.0.1:{port}", SYMBIONT_NUM_PROCESSES="2",
                   SYMBIONT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                                      cwd=str(REPO), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        jax_out = next(jax_side)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
    reports = [json.loads((tmp / f"report_{r}.json").read_text()) for r in range(2)]
    return reports, jax_out, json.loads((tmp / "one.json").read_text()), seconds


LM_CALLS = ["dense", "stream", "session_one_chunk", "session", "int8", "paged", "radix",
            "spec", "spec_stream", "spec_counts"]


@pytest.mark.parametrize("call", LM_CALLS)
def test_lm_call_across_processes(run, call):
    """Greedy float32 tokens (and, for the radix sessions, the radix stats
    and the pages live and free after; for spec, the drafts proposed and
    accepted) bit-equal between the two processes, equal to the port's
    one-process TP engine on [1, 2] and to JAX's `LmEngine`."""
    reports, jax_out, one, _ = run
    a, b = (r["lm"][call] for r in reports)
    assert a == b, f"{call}: the two processes differ"
    assert a == one["lm"][call], f"{call}: the one-process TP engine differs"
    assert a == jax_out["lm"][call], f"{call}: JAX's LmEngine differs"


SAMPLED_CALLS = ["dense_batch", "dense_stream", "dense_session", "paged_batch", "paged_stream",
                 "paged_session", "paged_pool", "spec", "spec_counts"]


@pytest.mark.parametrize("call", SAMPLED_CALLS)
def test_sampled_lm_call_across_processes(run, call):
    """At `LmConfig`'s default temperature and top_k, the sampled tokens
    (and the paged engine's radix stats and pages after; the drafts
    proposed and accepted) bit-equal between the two processes and equal
    to the port's one-process TP engine on the same seed."""
    reports, _, one, _ = run
    a, b = (r["sampled"][call] for r in reports)
    assert a == b, f"sampled {call}: the two processes differ"
    assert a == one["sampled"][call], f"sampled {call}: the one-process TP engine differs"


def test_sampling_draws_differ_from_greedy(run):
    """The sampled cases really draw: their batch differs from the greedy
    one on the same prompts."""
    r = run[0][0]
    assert r["sampled"]["dense_batch"] != r["lm"]["dense"]
    assert r["sampled"]["paged_batch"] != r["lm"]["paged"]


def test_lm_layout_across_processes(run):
    """Both meshes span the processes; each process holds one of the q
    kernel's two shards, one pool shard of one KV head, and the drafter
    whole; the radix sessions hit."""
    for r in run[0]:
        assert r["spans"] == [True, True]
        assert r["layout"]["q"] == [[None, "tensor"], 1]
        assert (r["layout"]["pool_shards"], r["layout"]["pool_heads"]) == (1, 1)
        assert r["layout"]["drafter_whole"]
        stats = r["lm"]["radix"][3]
        assert stats["hits"] >= 1 and stats["full_hits"] >= 1
        assert r["lm"]["spec_counts"][0] > 0


def test_page_tables_and_pool_stay_equal_across_processes(run):
    """The host page table, the free list and the refcounts after every
    chunk of the radix sessions: equal in both processes (one allocator
    each, fed the same calls) and equal to the one-process engine's."""
    a, b = (r["page_trace"] for r in run[0])
    assert a and a == b
    assert a == run[2]["page_trace"]


def test_store_search_across_processes(run):
    """The row-split store on [2, 1] across the processes: each process
    holds one row block, and the hits (ids, scores, order, the tie across
    the shards to the lower row) are bit-equal between the processes and
    to the one-process store; JAX's store gives the same ids and scores
    within 1e-6."""
    reports, jax_out, one, _ = run
    a, b = (r["store"]["search"] for r in reports)
    assert a == b == one["store"]["search"]
    for got, want in zip(a, jax_out["store"]["search"], strict=True):
        assert [h[0] for h in got] == [h[0] for h in want]
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], atol=1e-6)
    tie = a[-1]
    assert [h[0] for h in tie[:2]] == ["p3", f"p{BLOCK + 40}"]


def test_fused_query_across_processes(run):
    """`search_fused` through a `TorchEngine` on [2, 1]: the query's
    encoder on each process's lead, the store's search across the
    processes; bit-equal between them and to the one-process engine, the
    ids of JAX's `search_fused` and its scores within 1e-4."""
    reports, jax_out, one, _ = run
    a, b = (r["store"]["fused"] for r in reports)
    assert a == b == one["store"]["fused"]
    for got, want in zip(a, jax_out["store"]["fused"], strict=True):
        assert [h[0] for h in got] == [h[0] for h in want]
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], atol=1e-4)


def test_online_pass_across_processes(run):
    """One online pass over a TP engine whose tensor line crosses the
    processes (the step summing across them, the sync shard for shard): the
    loss bit-equal between the processes and within rtol 1e-4 of JAX's
    one-device step; the tokens after the sync equal the one-process TP
    engine's after the same pass."""
    reports, jax_out, one, _ = run
    a, b = (r["online"] for r in reports)
    assert a == b
    np.testing.assert_allclose(a["loss"], jax_out["online"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(a["loss"], one["online"]["loss"], rtol=1e-4)
    assert a["after"] == one["online"]["after"]


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_jax_cannot_serve_across_processes_raises(run, name):
    """DP embed, rerank and warm-up (outputs split over 'data'), a
    checkpoint of a spanning state or tree, `GenBatcher`, the runner and
    the serving mesh from a config raise in both processes, naming why the
    JAX package cannot run them across processes either."""
    for r in run[0]:
        msg = r["refusals"][name]
        assert msg is not None, f"{name} ran over a mesh that spans processes"
        assert "in the JAX package either" in msg and REFUSED[name] in msg, msg


def test_the_workers_take_under_their_budget(run):
    assert run[3] < WORKER_TIMEOUT_S


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
