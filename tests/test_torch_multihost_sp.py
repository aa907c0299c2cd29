"""Sequence and pipeline parallelism over a mesh that spans processes:
ring attention, Ulysses and the GPipe pipeline across two processes, held
to the port's one-process meshes and to the JAX package's on its virtual
CPU devices.

Two processes (this file run as a script, one per "host") join one gloo
world on a localhost coordinator with 4 CPU entries each. Each runs, in
the same order with the same whole inputs:

- forwards, gathered (`Sharded.gather`): `ring_attention_sharded` over
  the 8 entries (GQA, causal and not), `ulysses_attention_sharded` over 4
  (2 a process), and `gpt_forward_sp` with each scheme;
- two train steps of each of `make_lm_train_step_sp` (ring over 8,
  Ulysses over 4) and `make_lm_train_step_pp` (pipe 4 with 2 stages a
  process, pipe 2 with 1), on a 4-layer llama (GQA) and a 4-layer GPT-2
  with `attn_impl="flash"` (the plain versions of B1-B3 on its path),
  over a batch of 4 microbatches whose rows differ in ids and mask;
- the pipe-2 GPT-2 step once more with process 1's backward sending each
  microbatch's activation gradient one exchange late, as two processes
  whose backward took the microbatch chains in different orders would
  pair them.

The parent writes the param trees, runs the same calls on one-process
meshes of the port and JAX's on its meshes meanwhile, and holds both
processes to each other bit for bit, and to both references at the
tolerances of `tests/test_torch_sequence_parallel.py` (attention atol
1e-5 / rtol 1e-4, forward 2e-4 / 1e-3) and of the train steps (loss rtol
1e-5, grad norm 1e-4, masters atol 1e-4 / rtol 1e-3). The late case must
miss those bars. The workers import no JAX.
"""

import contextlib
import dataclasses
import hashlib
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
N_PROCS, N_LOCAL, STEPS, LR = 2, 4, 2, 1e-3
WORKER_TIMEOUT_S = 120
ATTN = dict(atol=1e-5, rtol=1e-4)
FWD = dict(atol=2e-4, rtol=1e-3)
BASE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4, intermediate_size=64,
            max_position_embeddings=64, dtype="float32")
MODELS = {"llama": dict(BASE, arch="llama", num_kv_heads=2),
          "gpt2": dict(BASE, arch="gpt2")}
# forward cases: (function, entries on the line, causal)
ATTENTION = {"ring-full": ("ring", 8, False), "ring-causal": ("ring", 8, True),
             "ulysses-full": ("ulysses", 4, False), "ulysses-causal": ("ulysses", 4, True)}
FORWARD_SP = {"gpt_forward_sp-ring": ("ring", 8), "gpt_forward_sp-ulysses": ("ulysses", 4)}
# train cases: (scheme, entries on the line, model)
TRAIN = {f"{scheme}{n}-{model}": (scheme, n, model)
         for model in MODELS for scheme, n in (("ring", 8), ("ulysses", 4), ("pp", 4), ("pp", 2))}
LATE = ("pp", 2, "gpt2")
JAX_TRAIN = [name for name, (_, _, model) in TRAIN.items() if model == "llama"]
JAX_CASES = [*ATTENTION, *FORWARD_SP, *JAX_TRAIN]  # half in the parent, half in a helper


def _qkv(seed, B, S, NH, D, KVH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, NH, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32),
            rng.normal(size=(B, S, KVH, D)).astype(np.float32))


def _attention_inputs(name):
    scheme = ATTENTION[name][0]
    return _qkv(2, 2, 64, 4, 16, 2) if scheme == "ring" else _qkv(4, 2, 64, 8, 16, 8)


def _batch():
    """[8, 32]: 4 microbatches of 2 rows, every row's ids its own and
    each row's mask a tail of its own length (row 0 whole)."""
    rng = np.random.default_rng(7)
    ids = rng.integers(1, BASE["vocab_size"], (8, 32)).astype(np.int32)
    mask = np.ones((8, 32), np.int32)
    for r in range(1, 8):
        mask[r, 32 - 3 * r:] = 0
    return ids, mask


def _ids():
    return np.random.default_rng(6).integers(0, BASE["vocab_size"], (2, 32)).astype(np.int32)


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


def _port(model):
    """The port's config and params of `model` from the parent's tree."""
    from symbiont_tpu_torch.models import gpt as tgpt
    from symbiont_tpu_torch.models.bridge import gpt_params_from_numpy

    cfg = tgpt.GPTConfig(**MODELS[model])
    if model == "gpt2":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    return cfg, gpt_params_from_numpy(_unflatten(dict(np.load(_PARAMS[model]))), "cpu")


_PARAMS: dict = {}  # model → its npz, set by the worker


# --------------------------------------------------- the calls, any mesh


def run_calls(meshes, names, late=None) -> dict:
    """The cases `names` on the port over `meshes(kind, n)` → {case:
    outputs}: numpy arrays of the forwards and of the updated masters
    (whole), and each step's loss and grad norm. Over a mesh that spans
    processes each result is gathered (a collective: both processes make
    every call). `late`: the context the late case runs in."""
    from symbiont_tpu_torch.parallel import (gpt_forward_sp, make_lm_train_step_pp,
                                             make_lm_train_step_sp, make_pp_train_state,
                                             ring_attention_sharded, ulysses_attention_sharded)
    from symbiont_tpu_torch.parallel.sharding import Sharded, gather_tree
    from symbiont_tpu_torch.train import trainer

    def whole(x):
        return x.gather() if isinstance(x, Sharded) else x

    ids, mask = _batch()
    batch = {"ids": torch.from_numpy(ids).long(), "mask": torch.from_numpy(mask)}
    out = {}
    for name in names:
        if name in ATTENTION or name in FORWARD_SP:
            with torch.no_grad():
                if name in ATTENTION:
                    scheme, n, causal = ATTENTION[name]
                    fn = ring_attention_sharded if scheme == "ring" else ulysses_attention_sharded
                    got = fn(*map(torch.from_numpy, _attention_inputs(name)), meshes("sp", n),
                             causal=causal)
                else:
                    (scheme, n), (cfg, params) = FORWARD_SP[name], _port("llama")
                    got = gpt_forward_sp(params, torch.from_numpy(_ids()), meshes("sp", n), cfg,
                                         attn_impl=scheme)
                out[name] = {"out": whole(got).numpy(), "sharded": isinstance(got, Sharded)}
            continue
        scheme, n, model = LATE if name == "late" else TRAIN[name]
        cfg, params = _port(model)
        if scheme == "pp":
            mesh = meshes("pp", n)
            state, tx = make_pp_train_state(mesh, params, learning_rate=LR)
            step = make_lm_train_step_pp(mesh, cfg, tx, num_microbatches=4)
        else:
            state, tx = trainer.make_lm_train_state(params, learning_rate=LR)
            step = make_lm_train_step_sp(meshes("sp", n), cfg, tx, attn_impl=scheme)
        steps = []
        with late if name == "late" else contextlib.nullcontext():
            for _ in range(STEPS):
                state, m = step(state, batch)
                steps.append([float(m["loss"]), float(m["grad_norm"])])
        with torch.no_grad():
            leaves = trainer.tree_leaves(gather_tree(state.params))
        out[name] = {"steps": steps, "leaves": [t.detach().numpy() for t in leaves]}
    return out


class _late_gradients:
    """Process 1's backward exchanges send each received activation's
    gradient one exchange late (zeros first): the gradient of microbatch
    m + 1 lands on microbatch m's activation in process 0, as a backward
    that took the microbatch chains in another order than process 0's
    would pair them."""

    def __init__(self, rank):
        self.rank = rank

    def __enter__(self):
        from symbiont_tpu_torch.parallel import sharding

        self.cls, self.real = sharding._Exchange, sharding._Exchange.backward
        if self.rank != 1:
            return self
        held = []
        real = self.real

        def backward(ctx, g_token, *g_got):
            held.append([g.clone() for g in g_got])
            sent = held.pop(0) if len(held) > 1 else [torch.zeros_like(g) for g in g_got]
            return real(ctx, g_token, *sent)

        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.real)
        return False


def _checksum(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------------ worker


def _worker(out_dir: str) -> int:
    """One process of the two: join the world, run every case over meshes
    that span both processes, and write `report_<rank>.npz`."""
    assert "jax" not in sys.modules, "the port's worker must not import JAX"
    from symbiont_tpu_torch.parallel import mesh as mesh_mod

    torch.manual_seed(0)
    n_global = mesh_mod.init_distributed(devices=[CPU] * N_LOCAL)
    rank = mesh_mod.process_index()
    world = np.empty(n_global, dtype=object)
    world[:] = mesh_mod.world_devices()
    grid = world.reshape(N_PROCS, N_LOCAL)  # the entries of process p: grid[p]
    _PARAMS.update({m: Path(out_dir) / f"{m}.npz" for m in MODELS})

    def meshes(kind, n):
        """n entries, n / 2 of each process, in process order."""
        entries = grid[:, :n // N_PROCS].reshape(n)
        mesh = (mesh_mod.Mesh(entries.reshape(n, 1), ("data", "tensor")) if kind == "sp"
                else mesh_mod.Mesh(entries, ("pipe",)))
        assert mesh.spans_processes and len(mesh.local_entries) == n // N_PROCS
        return mesh

    def one_process(kind, n):
        """The same line within this process: n entries repeating the CPU."""
        axes = ("data", "tensor") if kind == "sp" else ("pipe",)
        return mesh_mod.build_mesh([n, 1] if kind == "sp" else [n], axes, devices=[CPU] * n)

    _save(run_calls(meshes, [*ATTENTION, *FORWARD_SP, *TRAIN, "late"],
                    late=_late_gradients(rank)), Path(out_dir) / f"report_{rank}.npz")
    mesh_mod.shutdown_distributed()
    # the one-process references, half of the cases in each worker
    cases = [*ATTENTION, *FORWARD_SP, *TRAIN]
    _save(run_calls(one_process, cases[rank::N_PROCS]), Path(out_dir) / f"one_{rank}.npz")
    return 0


def _save(out: dict, path) -> None:
    flat = {}
    for name, r in out.items():
        for k, v in r.items():
            if k == "leaves":
                flat.update({f"{name}/leaves/{j}": a for j, a in enumerate(v)})
            else:
                flat[f"{name}/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def _read(path) -> dict:
    """A worker's report back as `run_calls` returned it."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, k, *j = key.split("/")
            if k == "leaves":
                out.setdefault(name, {}).setdefault("leaves", {})[int(j[0])] = z[key]
            else:
                out.setdefault(name, {})[k] = z[key]
    for r in out.values():
        if "leaves" in r:
            r["leaves"] = [r["leaves"][j] for j in range(len(r["leaves"]))]
    return out


# ------------------------------------------------------------------ parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy_tree(jcfg, seed):
    """JAX's GPT tree for jcfg (the layout of `init_params`, traced, not
    run op by op), its leaves drawn from a numpy seed: N(0, 0.02), norm
    scales about 1."""
    import jax

    from symbiont_tpu.models import gpt as jgpt

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        x = rng.normal(0.0, 0.02, leaf.shape).astype(np.float32)
        return x + 1.0 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(lambda: jgpt.init_params(jax.random.key(0), jcfg)))


def _jax_case(name, trees):
    """One case on JAX's functions over its virtual CPU devices (the
    GPT-2 with JAX's own attention: the port's flash path is the same
    function)."""
    import jax
    import jax.numpy as jnp

    from symbiont_tpu.models import gpt as jgpt
    from symbiont_tpu.parallel import build_mesh as jax_build_mesh
    from symbiont_tpu.parallel import context as jcontext
    from symbiont_tpu.parallel import pipeline as jpipeline
    from symbiont_tpu.parallel.ring_attention import ring_attention_sharded as jring
    from symbiont_tpu.parallel.ulysses import ulysses_attention_sharded as julysses
    from symbiont_tpu.train import trainer as jtrain

    def mesh(kind, n):
        if kind == "sp":
            return jax_build_mesh([n, 1], devices=jax.devices()[:n])
        return jax_build_mesh([n], axis_names=("pipe",), devices=jax.devices()[:n])

    if name in ATTENTION:
        scheme, n, causal = ATTENTION[name]
        fn, m = (jring if scheme == "ring" else julysses), mesh("sp", n)
        run = jax.jit(lambda a, b, c: fn(a, b, c, m, axis_name="data", causal=causal))
        return {"out": np.asarray(run(*map(jnp.asarray, _attention_inputs(name))))}
    if name in FORWARD_SP:
        scheme, n = FORWARD_SP[name]
        jcfg, m = jgpt.GPTConfig(**MODELS["llama"]), mesh("sp", n)
        return {"out": np.asarray(jax.jit(lambda p, i: jcontext.gpt_forward_sp(
            p, i, m, jcfg, axis="data", attn_impl=scheme))(
            jax.tree.map(jnp.asarray, trees["llama"]), jnp.asarray(_ids())))}
    scheme, n, model = TRAIN[name]
    ids, mask = _batch()
    jbatch = {"ids": jnp.asarray(ids), "mask": jnp.asarray(mask)}
    jcfg = jgpt.GPTConfig(**MODELS[model])
    tree = jax.tree.map(jnp.asarray, trees[model])
    if scheme == "pp":
        state, tx = jpipeline.make_pp_train_state(mesh("pp", n), tree, learning_rate=LR)
        step = jpipeline.make_lm_train_step_pp(mesh("pp", n), jcfg, tx, num_microbatches=4)
    else:
        state, tx = jtrain.make_lm_train_state(tree, learning_rate=LR)
        step = jcontext.make_lm_train_step_sp(mesh("sp", n), jcfg, tx, axis="data",
                                              attn_impl=scheme)
    steps = []
    for _ in range(STEPS):
        state, m = step(state, jbatch)
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    return {"steps": np.asarray(steps),
            "leaves": [np.asarray(a) for a in jax.tree.leaves(state.params)]}


def _jax_worker(out_dir: str) -> int:
    """The JAX half of the references that the parent hands off
    (`JAX_CASES[1::2]`), from the trees it wrote → `jax_1.npz`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    trees = {m: _unflatten(dict(np.load(Path(out_dir) / f"{m}.npz"))) for m in MODELS}
    _save({name: _jax_case(name, trees) for name in JAX_CASES[1::2]},
          Path(out_dir) / "jax_1.npz")
    return 0


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Write the param trees, start the two workers (each then runs half
    of the one-process references) and a helper that runs half of JAX's,
    run the other half of JAX's meanwhile, and collect: (the workers'
    reports by rank, the one-process port's, JAX's, seconds)."""
    from symbiont_tpu.models import gpt as jgpt

    tmp = tmp_path_factory.mktemp("multihost_sp")
    trees = {m: _numpy_tree(jgpt.GPTConfig(**kw), 11 + j)
             for j, (m, kw) in enumerate(MODELS.items())}
    for m, tree in trees.items():
        np.savez(tmp / f"{m}.npz", **_flatten(tree))
    port = _free_port()
    t0 = time.perf_counter()
    procs = []
    for pid in range(N_PROCS):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                   SYMBIONT_COORDINATOR=f"127.0.0.1:{port}",
                   SYMBIONT_NUM_PROCESSES=str(N_PROCS), SYMBIONT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                                      cwd=str(REPO), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    procs.append(subprocess.Popen([sys.executable, __file__, str(tmp), "--jax"],
                                  env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(REPO),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        jax_out = {name: _jax_case(name, trees) for name in JAX_CASES[::2]}
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
    reports = [_read(tmp / f"report_{r}.npz") for r in range(N_PROCS)]
    one = {k: v for r in range(N_PROCS) for k, v in _read(tmp / f"one_{r}.npz").items()}
    jax_out.update(_read(tmp / "jax_1.npz"))
    return reports, one, jax_out, seconds


@pytest.mark.parametrize("name", list(ATTENTION) + list(FORWARD_SP))
def test_forward_across_processes(run, name):
    """A forward over a mesh that spans processes returns a `Sharded` of
    this process's blocks; gathered, it is bit-equal between the
    processes, equal to the one-process mesh's and to JAX's."""
    reports, one, jax_out, _ = run
    a, b = (r[name] for r in reports)
    assert bool(a["sharded"]) and bool(b["sharded"]) and not one[name]["sharded"]
    np.testing.assert_array_equal(a["out"], b["out"])
    tol = ATTN if name in ATTENTION else FWD
    np.testing.assert_allclose(a["out"], one[name]["out"], **tol)
    np.testing.assert_allclose(a["out"], jax_out[name]["out"], **tol)


def _hold(got, want):
    """Each step's loss (rtol 1e-5) and grad norm (1e-4), and every updated
    master (atol 1e-4, rtol 1e-3), leaf by leaf (a PP state's stacked, on
    both packages)."""
    for (loss, gn), (wloss, wgn) in zip(got["steps"], want["steps"], strict=True):
        np.testing.assert_allclose(loss, wloss, rtol=1e-5)
        np.testing.assert_allclose(gn, wgn, rtol=1e-4)
    for a, b in zip(got["leaves"], want["leaves"], strict=True):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_across_processes(run, name):
    """Two SP or PP steps over a mesh that spans processes: the two
    processes' losses, grad norms and updated masters bit-equal; each
    equal to the one-process mesh's step at the train bars, and the
    llama's to JAX's (the GPT-2's one-process flash steps are held to the
    plain step, and so to JAX's, by `tests/test_torch_sequence_parallel.py`
    and `tests/test_torch_pipeline.py`)."""
    reports, one, jax_out, _ = run
    a, b = (r[name] for r in reports)
    np.testing.assert_array_equal(a["steps"], b["steps"])
    assert _checksum(a["leaves"]) == _checksum(b["leaves"]), "the processes' masters differ"
    got = {"steps": a["steps"].tolist(), "leaves": a["leaves"]}
    _hold(got, {"steps": one[name]["steps"].tolist(), "leaves": one[name]["leaves"]})
    if name in JAX_TRAIN:
        _hold(got, {"steps": jax_out[name]["steps"].tolist(), "leaves": jax_out[name]["leaves"]})


def test_a_late_microbatch_gradient_misses_the_bars(run):
    """The pipe-2 GPT-2 step with process 1 sending each microbatch's
    activation gradient one exchange late: the loss is the forward's (the
    same), the grad norm and the masters are not, so the bars of
    `test_train_step_across_processes` would fail a backward whose
    exchanges paired the microbatches wrongly."""
    reports, one, _, seconds = run
    late, want = reports[0]["late"], one["pp2-gpt2"]
    want = {"steps": want["steps"].tolist(), "leaves": want["leaves"]}
    np.testing.assert_allclose(late["steps"][0][0], want["steps"][0][0], rtol=1e-5)
    with pytest.raises(AssertionError):
        _hold({"steps": late["steps"].tolist(), "leaves": late["leaves"]}, want)
    assert not np.isclose(late["steps"][0][1], want["steps"][0][1], rtol=1e-4)
    assert seconds < WORKER_TIMEOUT_S


if __name__ == "__main__":
    sys.exit(_jax_worker(sys.argv[1]) if sys.argv[2:] == ["--jax"] else _worker(sys.argv[1]))
