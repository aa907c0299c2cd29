"""A15 multi-host on the port: `init_distributed` and a mesh that spans
processes, held to the JAX package's `tests/test_multihost.py`.

Two processes (this file run as a script, one per "host") join one gloo
world on a localhost coordinator, each with 4 CPU entries, and build ONE
8-entry mesh over both. Each runs the production `shard_lm_train_state` +
`lm_train_step` in two modes, as the JAX worker does:

- "dp": [8, 1] over the world in process order; the gradient sum over
  'data' crosses processes;
- "tp": a [4, 2] mesh whose 'tensor' axis pairs entry i of process 0 with
  entry i of process 1 (`world.reshape(2, 4).T`), so every tensor-parallel
  sum (the row-split projections, the vocab-split embedding, the split
  head) crosses processes.

Both processes must report bit-equal losses, grad norms and checksums of
their updated masters, and these must agree with JAX's one-device
`lm_train_step` on the same param tree and batch (the JAX tree written
by the parent, the JAX run in the parent). The workers import no JAX. A
mesh that spans processes refuses serving and SP/PP by name.
"""

import hashlib
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

from symbiont_tpu_torch.parallel import mesh as mesh_mod

REPO = Path(__file__).resolve().parent.parent
# the JAX worker's model (tests/multihost_worker.py), flash attention on the port
MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
             max_position_embeddings=32, arch="llama", num_kv_heads=2, dtype="float32",
             tie_word_embeddings=True)
N_PROCS, N_LOCAL, STEPS = 2, 4, 2
WORKER_TIMEOUT_S = 120
REFUSALS = {  # what a worker tries over a mesh that spans processes → the ROADMAP item
    "TorchEngine": "A15 multi-host serving", "VectorStore": "A15 multi-host serving",
    "LmEngine": "A15 multi-host serving", "gpt.forward with a cache": "A15 multi-host serving",
    "mesh_from_config": "A15 multi-host serving", "runner": "A15 multi-host serving",
    "ring_attention": "SP/PP across processes", "ring_attention_sharded": "SP/PP across processes",
    "ulysses_attention": "SP/PP across processes",
    "ulysses_attention_sharded": "SP/PP across processes",
    "make_lm_train_step_sp": "SP/PP across processes",
    "gpt_forward_sp": "SP/PP across processes",
    "make_lm_train_step_pp": "SP/PP across processes",
    "make_pp_train_state": "SP/PP across processes",
}


def _batch():
    """The JAX worker's batch (`default_rng(7)`, [8, 16]), with row 5's
    tail masked so the processes' weight sums differ."""
    rng = np.random.default_rng(7)
    ids = rng.integers(1, MODEL["vocab_size"], (8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.int32)
    mask[5, 10:] = 0
    return ids, mask


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


def _checksum(tree) -> str:
    """sha256 of every leaf's bytes in `tree_leaves` order."""
    from symbiont_tpu_torch.train.trainer import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ worker


def _refusals(dp_mesh, tp_mesh, params, cfg) -> dict:
    """Each entry point a mesh across processes refuses → its message."""
    from symbiont_tpu_torch import runner
    from symbiont_tpu_torch.config import (EngineConfig, LmConfig, ParallelConfig,
                                           SymbiontConfig, VectorStoreConfig)
    from symbiont_tpu_torch.engine.engine import TorchEngine
    from symbiont_tpu_torch.engine.lm import LmEngine
    from symbiont_tpu_torch.memory.vector_store import VectorStore
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.parallel import (context, pipeline, ring_attention,
                                             ring_attention_sharded, shard_params,
                                             gpt_param_sharding, ulysses_attention,
                                             ulysses_attention_sharded)

    q = torch.zeros((1, 8, 4, 16))
    blocks = [q if i in dp_mesh.local_entries else None for i in range(dp_mesh.size)]
    placed = shard_params(tp_mesh, params, gpt_param_sharding(tp_mesh, params, arch="llama"))
    tries = {
        "TorchEngine": lambda: TorchEngine(EngineConfig(force_cpu=True), mesh=dp_mesh),
        "VectorStore": lambda: VectorStore(VectorStoreConfig(dim=8, data_dir=""), mesh=dp_mesh),
        "LmEngine": lambda: LmEngine(LmConfig(force_cpu=True), mesh=tp_mesh),
        "gpt.forward with a cache": lambda: tgpt.forward(
            placed, torch.ones((1, 4), dtype=torch.long),
            tgpt.init_cache(cfg, 1, 8, torch.float32, "cpu"),
            torch.arange(4)[None], cfg),
        "mesh_from_config": lambda: mesh_mod.mesh_from_config(
            ParallelConfig(mesh_shape=[8, 1]), cpu=True),
        "runner": lambda: runner._refuse_unported(SymbiontConfig(), dp_mesh, False),
        "ring_attention": lambda: ring_attention(blocks, blocks, blocks),
        "ring_attention_sharded": lambda: ring_attention_sharded(q, q, q, dp_mesh),
        "ulysses_attention": lambda: ulysses_attention(blocks, blocks, blocks),
        "ulysses_attention_sharded": lambda: ulysses_attention_sharded(q, q, q, dp_mesh),
        "make_lm_train_step_sp": lambda: context.make_lm_train_step_sp(dp_mesh, cfg, None),
        "gpt_forward_sp": lambda: context.gpt_forward_sp(
            params, torch.ones((1, 8), dtype=torch.long), dp_mesh, cfg),
        "make_lm_train_step_pp": lambda: pipeline.make_lm_train_step_pp(dp_mesh, cfg, None),
        "make_pp_train_state": lambda: pipeline.make_pp_train_state(
            mesh_mod.build_mesh([8], ("pipe",)), params),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _worker(params_path: str, out_dir: str) -> int:
    """One process of the two: join the world, run both modes, write
    `report_<rank>.json` and the gathered q kernels into `out_dir`."""
    assert "jax" not in sys.modules, "the port's worker must not import JAX"
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy
    from symbiont_tpu_torch.parallel import build_mesh, init_distributed, world_devices
    from symbiont_tpu_torch.parallel.sharding import Sharded, gather_tree
    from symbiont_tpu_torch.train import trainer

    torch.manual_seed(0)
    n_global = init_distributed(devices=[torch.device("cpu")] * N_LOCAL)
    rank, procs = mesh_mod.process_index(), mesh_mod.process_count()
    with np.load(params_path) as z:
        params = gpt_params_from_numpy(_unflatten({k: z[k] for k in z.files}), "cpu")
    cfg = tgpt.GPTConfig(**MODEL, attn_impl="flash")
    ids, mask = _batch()
    batch = {"ids": torch.from_numpy(ids).long(), "mask": torch.from_numpy(mask)}
    world = np.empty(n_global, dtype=object)
    world[:] = world_devices()
    meshes = {"dp": build_mesh([n_global, 1]),
              "tp": mesh_mod.Mesh(world.reshape(procs, N_LOCAL).T, ("data", "tensor"))}
    report = {"global": n_global, "local": N_LOCAL, "procs": procs,
              "backend": list(mesh_mod.distributed_backend())}
    for mode, mesh in meshes.items():
        state, tx = trainer.make_lm_train_state(params)
        state, tx = trainer.shard_lm_train_state(mesh, state, tx, arch="llama")
        steps = []
        for _ in range(STEPS):
            state, m = trainer.lm_train_step(state, batch, cfg, tx)
            steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
        qk = state.params["layers"][0]["q"]["kernel"]
        with torch.no_grad():
            whole = gather_tree(state.params)
        np.save(Path(out_dir) / f"q_{mode}_{rank}.npy", whole["layers"][0]["q"]["kernel"].numpy())
        report[mode] = {"steps": steps, "checksum": _checksum(whole),
                        "spans": mesh.spans_processes,
                        "q_spec": list(qk.spec), "q_sharded": isinstance(qk, Sharded),
                        "q_addressable": sum(t is not None for t in qk.shards),
                        "q_entries": len(qk.shards),
                        "tensor_pairs_span": all(
                            len({mesh.process_index(mesh.flat_index(data=d, tensor=t))
                                 for t in range(mesh.shape["tensor"])}) == procs
                            for d in range(mesh.shape["data"]))}
    report["refusals"] = _refusals(meshes["dp"], meshes["tp"], params, cfg)
    (Path(out_dir) / f"report_{rank}.json").write_text(json.dumps(report))
    mesh_mod.shutdown_distributed()
    return 0


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write JAX's param tree, start the two workers, run JAX's one-device
    steps while they run, and collect their reports: (reports by rank, the
    JAX steps, JAX's updated q kernel, the workers' q kernels, seconds)."""
    import jax
    import jax.numpy as jnp

    from symbiont_tpu.models import gpt as jgpt
    from symbiont_tpu.train import trainer as jtrain

    tmp = tmp_path_factory.mktemp("multihost")
    jcfg = jgpt.GPTConfig(**MODEL)
    tree = jax.tree.map(np.asarray, jgpt.init_params(jax.random.key(0), jcfg))
    np.savez(tmp / "params.npz", **_flatten(tree))
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for pid in range(N_PROCS):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                   SYMBIONT_COORDINATOR=f"127.0.0.1:{port}",
                   SYMBIONT_NUM_PROCESSES=str(N_PROCS), SYMBIONT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / "params.npz"), str(tmp)], env=env,
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ids, mask = _batch()
        jstate, jtx = jtrain.make_lm_train_state(jax.tree.map(jnp.asarray, tree))
        jbatch = {"ids": jnp.asarray(ids), "mask": jnp.asarray(mask)}
        jsteps = []
        for _ in range(STEPS):
            jstate, jm = jtrain.lm_train_step(jstate, jbatch, jcfg, jtx)
            jsteps.append({"loss": float(jm["loss"]), "grad_norm": float(jm["grad_norm"])})
        jq = np.asarray(jstate.params["layers"][0]["q"]["kernel"])
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
    reports = [json.loads((tmp / f"report_{r}.json").read_text()) for r in range(N_PROCS)]
    qs = {(mode, r): np.load(tmp / f"q_{mode}_{r}.npy") for mode in ("dp", "tp")
          for r in range(N_PROCS)}
    return reports, jsteps, jq, qs, seconds


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_two_process_train_step(run, mode):
    """One 8-entry mesh over two processes; the production train step in
    each: bit-equal across the processes, JAX's one-device step within
    rtol 1e-4, the updated q kernel to float32 noise; in "tp" the q kernel
    stays split on 'tensor' with 4 of its 8 shards in each process."""
    reports, jsteps, jq, qs, _ = run
    for r in reports:
        assert (r["global"], r["local"], r["procs"]) == (8, 4, 2)
        assert r["backend"][0] == "gloo"
        assert r[mode]["spans"] and r[mode]["q_sharded"]
    a, b = (r[mode] for r in reports)
    assert a["steps"] == b["steps"], "the two processes' losses or grad norms differ"
    assert a["checksum"] == b["checksum"], "the two processes' masters differ"
    for got, want in zip(a["steps"], jsteps, strict=True):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    for rank in range(N_PROCS):
        np.testing.assert_allclose(qs[(mode, rank)], jq, atol=1e-6, rtol=1e-4)
    if mode == "tp":
        assert a["tensor_pairs_span"] and a["q_spec"] == [None, "tensor"]
        assert (a["q_addressable"], a["q_entries"]) == (b["q_addressable"], b["q_entries"]) \
            == (4, 8)
    else:
        assert a["q_spec"] == [None, "tensor"] and a["q_addressable"] == 4


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_a_mesh_across_processes_refuses_by_name(run, name):
    """Serving and SP/PP over a mesh that spans processes raise a
    ValueError naming their ROADMAP item, in both processes: nothing runs
    one process's part alone."""
    for r in run[0]:
        msg = r["refusals"][name]
        assert msg is not None, f"{name} ran over a mesh that spans processes"
        assert f"ROADMAP {REFUSALS[name]}" in msg, msg


# ------------------------------------------------------- a world of one


@pytest.fixture
def world_of_one(monkeypatch):
    """The distributed world left as it was found after the test."""
    for var in ("SYMBIONT_COORDINATOR", "SYMBIONT_NUM_PROCESSES", "SYMBIONT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    yield
    mesh_mod.shutdown_distributed()


def test_init_distributed_takes_the_env_and_a_second_call_is_a_no_op(world_of_one,
                                                                     monkeypatch):
    """The env gives each argument left unset; a given argument wins (the
    bad coordinator in the env is never dialled); the world's entries are
    this process's `devices`, the backend gloo on the CPU; a second call
    returns the same count and joins nothing."""
    import torch.distributed as dist

    monkeypatch.setenv("SYMBIONT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SYMBIONT_NUM_PROCESSES", "1")
    monkeypatch.setenv("SYMBIONT_PROCESS_ID", "0")
    n = mesh_mod.init_distributed(f"127.0.0.1:{_free_port()}",
                                  devices=[torch.device("cpu")] * 3)
    assert n == 3 and dist.get_world_size() == 1
    assert [(str(d.device), d.process_index, d.card) for d in mesh_mod.world_devices()] == \
        [("cpu", 0, "cpu")] * 3
    assert mesh_mod.distributed_backend() == ("gloo", "entries on the CPU")
    assert mesh_mod.init_distributed("127.0.0.1:1", 1, 0) == 3
    mesh = mesh_mod.build_mesh([3, 1])
    assert not mesh.spans_processes and mesh.local_entries == [0, 1, 2]
    assert mesh.group(("data",), 0) is None
    mesh_mod.shutdown_distributed()
    assert not dist.is_initialized() and mesh_mod.process_count() == 1


def test_init_distributed_without_a_coordinator_raises(world_of_one):
    with pytest.raises(ValueError, match="SYMBIONT_COORDINATOR"):
        mesh_mod.init_distributed(num_processes=1, process_id=0)


@pytest.mark.parametrize("cards,backend", [
    ([["cpu"] * 4, ["cpu"] * 4], "gloo"),
    ([["GPU-a"], ["GPU-a"]], "gloo"),
    ([["GPU-a", "GPU-a"], ["GPU-b"]], "nccl"),
    ([["GPU-a"], ["GPU-b"], ["GPU-c", "GPU-d"]], "nccl"),
])
def test_the_backend_rule(cards, backend):
    """NCCL where every entry is a card and no card is in two processes;
    gloo on the CPU and where processes share a card, which names them."""
    got, why = mesh_mod.device_backend(cards)
    assert got == backend
    if cards[0] == cards[1] == ["GPU-a"]:
        assert "processes [0, 1] share card GPU-a" in why


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], sys.argv[2]))
