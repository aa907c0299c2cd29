"""Parameter and train-state checkpoints of the port.

The port's own copy of `symbiont_tpu/train/checkpoint.py`, on the same
on-disk format, so a checkpoint written by either package loads in the
other:

- params: a directory with `params.npz` (one array per leaf, keys the
  leaf's path joined with "\\x1f", list items as "#i") and `tree.json`
  (the tree's shape and a free `meta` dict). `load_params` returns the
  tree as numpy arrays, as the JAX loader does; `models.bridge` turns it
  into tensors. numpy has no bfloat16, so a bf16 tensor leaf is stored as
  float32 (the trainer's masters are float32 already).
- train state: `train_state.npz` (`leaf_0..`) and `train_meta.json`, the
  leaves in the order `jax.tree.leaves` gives a TrainState (the embedder's
  or the LM's, whose optax AdamW states have one layout):
  params (dict keys sorted), AdamW's step count (int32), the first
  moments (optax `mu`), the second moments (`nu`), then the step (int32).
  Both files are written to a temporary name, fsynced and renamed, so a
  crash mid-save leaves the previous checkpoint whole.

A train state placed on a mesh (`trainer.shard_lm_train_state`, the
online fine-tune of a tensor-parallel engine) saves in the same format:
each `Sharded` param and its two moments, read from the blocks' masters,
gathered whole. A save of a state or params placed on a mesh that spans
processes raises (`mesh.JAX_FETCH`: the JAX package's save fetches every
leaf with `np.asarray`, which raises on an array whose shards lie in other
processes). A load into such a template writes every local block of each
param and each master's moments in place, so the step executables bound
to them survive.

`embedder_train_state_from_numpy` and `lm_train_state_from_numpy` take a
JAX embedder or LM train state held in memory as numpy arrays instead of
on disk, so the port can go on training from where the JAX trainer
stopped.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy, gpt_params_from_numpy
from symbiont_tpu_torch.parallel.mesh import JAX_FETCH, refuse_spanning
from symbiont_tpu_torch.parallel.sharding import Sharded, mesh_of
from symbiont_tpu_torch.train.trainer import (
    TrainState,
    make_embedder_train_state,
    make_lm_train_state,
    masters,
    tree_leaves,
)

Params = Any

_SEP = "\x1f"  # unit separator — safe key joiner


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Params, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = _numpy(tree)
    return out


def _shape_of(tree: Params) -> Any:
    if isinstance(tree, dict):
        return {k: _shape_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_of(v) for v in tree]
    return None  # leaf marker


def _unflatten(shape: Any, flat: dict, prefix: str = "") -> Params:
    if isinstance(shape, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}{_SEP}") for k, v in shape.items()}
    if isinstance(shape, list):
        return [_unflatten(v, flat, f"{prefix}#{i}{_SEP}")
                for i, v in enumerate(shape)]
    return flat[prefix.rstrip(_SEP)]


def save_params(path: str | Path, params: Params, meta: Optional[dict] = None) -> None:
    refuse_spanning(mesh_of(params), "save_params of a placed tree", JAX_FETCH)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "params.npz", **_flatten(params))
    (path / "tree.json").write_text(json.dumps(
        {"tree": _shape_of(params), "meta": meta or {}}))


def load_params(path: str | Path) -> tuple[Params, dict]:
    """→ (tree of numpy arrays, meta)."""
    path = Path(path)
    spec = json.loads((path / "tree.json").read_text())
    with np.load(path / "params.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    return _unflatten(spec["tree"], flat), spec.get("meta", {})


def exists(path: str | Path) -> bool:
    path = Path(path)
    return (path / "params.npz").exists() and (path / "tree.json").exists()


def _state_leaves(state: TrainState) -> list:
    """The state's leaves in the JAX order as (param leaf, moment key):
    params (key None), count, mu ("exp_avg"), nu ("exp_avg_sq"), step
    (count and step as None: they are scalars kept apart)."""
    params = tree_leaves(state.params)
    return ([(p, None) for p in params] + [None] + [(p, "exp_avg") for p in params]
            + [(p, "exp_avg_sq") for p in params] + [None])


def _adam_count(state: TrainState) -> int:
    homes = masters(state.params)
    return int(state.opt_state[homes[0]]["step"]) if homes else 0


def _whole(state: TrainState, leaf, key: Optional[str]) -> torch.Tensor:
    """A param leaf (`key` None) or its AdamW moment `key`, whole: a
    mesh-placed leaf's blocks gathered from its masters."""
    if not isinstance(leaf, Sharded):
        return leaf if key is None else state.opt_state[leaf][key]
    if key is not None:
        leaf = Sharded(leaf.mesh, leaf.spec,
                       tuple(None if s is None else state.opt_state[leaf.home(i)][key]
                             for i, s in enumerate(leaf.shards)), leaf.shape)
    return leaf.gather()


def _write(state: TrainState, leaf, key: Optional[str], whole: torch.Tensor) -> None:
    """`whole` into a param leaf (`key` None: every local shard of a placed
    one) or its moment `key` (each master's block of a placed one)."""
    if not isinstance(leaf, Sharded):
        (leaf if key is None else state.opt_state[leaf][key]).copy_(whole)
        return
    for i, shard in enumerate(leaf.shards):
        if shard is None or (key is not None and leaf.home_index(i) != i):
            continue
        sl = tuple(slice(b * n, (b + 1) * n) for b, n in zip(leaf.block(i), shard.shape))
        (shard if key is None else state.opt_state[shard][key]).copy_(whole[sl])


def _write_atomic(final: Path, write) -> None:
    tmp = final.with_name(final.name + ".tmp")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())  # the rename must not outlive the data
    os.replace(tmp, final)


def save_train_state(path: str | Path, state: TrainState,
                     meta: Optional[dict] = None) -> None:
    """Params, both AdamW moments, the Adam count and the step, for resume."""
    refuse_spanning(mesh_of(state.params), "save_train_state of a placed state", JAX_FETCH)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = [np.asarray(_adam_count(state), np.int32) if t is None else _numpy(_whole(state, *t))
              for t in _state_leaves(state)]
    leaves[-1] = np.asarray(int(state.step), np.int32)
    # meta last — its presence implies a whole npz
    _write_atomic(path / "train_state.npz", lambda f: np.savez(
        f, **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}))
    _write_atomic(path / "train_meta.json", lambda f: f.write(json.dumps({
        "n_leaves": len(leaves),
        "shapes": [list(leaf.shape) for leaf in leaves],
        "dtypes": [str(leaf.dtype) for leaf in leaves],
        "meta": meta or {}}).encode()))


def load_train_state(path: str | Path, template: TrainState):
    """Restore a train state saved by either package's `save_train_state`
    into `template` (build it with `make_embedder_train_state` or
    `make_lm_train_state` on the same geometry): its tensors are
    overwritten in place, so the step executables bound to them survive. Returns (state, meta).
    Raises ValueError on a leaf-count or per-leaf shape mismatch."""
    path = Path(path)
    spec = json.loads((path / "train_meta.json").read_text())
    with np.load(path / "train_state.npz") as npz:
        leaves = [npz[f"leaf_{i}"] for i in range(spec["n_leaves"])]
    targets = _state_leaves(template)
    if len(targets) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(targets)} — model/optimizer config mismatch")
    # per-leaf shape check: equal leaf counts with different geometry must
    # fail HERE with a clear error, not later as a broadcast error
    for i, (leaf, tmpl) in enumerate(zip(leaves, targets)):
        t_shape = () if tmpl is None else tuple(tmpl[0].shape)
        if tuple(leaf.shape) != t_shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(leaf.shape)} != template "
                f"shape {t_shape} — model/optimizer config mismatch")
    count = float(leaves[len(tree_leaves(template.params))])
    with torch.no_grad():
        for leaf, tmpl in zip(leaves, targets):
            if tmpl is not None:
                _write(template, *tmpl, torch.from_numpy(np.array(leaf)))
        for p in masters(template.params):
            template.opt_state[p]["step"].fill_(count)
    return (TrainState(template.params, template.opt_state, int(leaves[-1])),
            spec.get("meta", {}))


def train_state_exists(path: str | Path) -> bool:
    path = Path(path)
    return ((path / "train_state.npz").exists()
            and (path / "train_meta.json").exists())


def _train_state_from_numpy(make, bridge, params, mu, nu, count, learning_rate, device):
    dev = resolve_device(device)
    state, tx = make(bridge(params, dev), learning_rate)
    moments = zip(tree_leaves(state.params), tree_leaves(bridge(mu, dev)),
                  tree_leaves(bridge(nu, dev)), strict=True)
    with torch.no_grad():
        for p, m, n in moments:
            tx.state[p]["exp_avg"].copy_(m)
            tx.state[p]["exp_avg_sq"].copy_(n)
            tx.state[p]["step"].fill_(float(count))
    return state._replace(step=int(count)), tx


def embedder_train_state_from_numpy(params: Params, mu: Params, nu: Params, count: int,
                                    learning_rate: float = 1e-4, device=None):
    """A JAX embedder train state as numpy (params, optax Adam `mu`/`nu` —
    trees shaped like params — and its `count`) → the port's (TrainState,
    AdamW) on CUDA unless `device="cpu"`, with the same masters, moments
    and count, so a step of either package from there takes the same
    update. The step is the count, as in the JAX embedder state."""
    return _train_state_from_numpy(make_embedder_train_state, bert_params_from_numpy,
                                   params, mu, nu, count, learning_rate, device)


def lm_train_state_from_numpy(params: Params, mu: Params, nu: Params, count: int,
                              learning_rate: float = 3e-4, device=None):
    """A JAX LM train state as numpy (the GPT tree of `models/gpt.py`,
    optax Adam `mu`/`nu` shaped like it, its `count`) → the port's
    (TrainState, AdamW), as `embedder_train_state_from_numpy`, through
    `models.bridge.gpt_params_from_numpy`."""
    return _train_state_from_numpy(make_lm_train_state, gpt_params_from_numpy,
                                   params, mu, nu, count, learning_rate, device)
