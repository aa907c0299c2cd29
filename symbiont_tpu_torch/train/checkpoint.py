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
  leaves in the order `jax.tree.leaves` gives an embedder TrainState:
  params (dict keys sorted), AdamW's step count (int32), the first
  moments (optax `mu`), the second moments (`nu`), then the step (int32).
  Both files are written to a temporary name, fsynced and renamed, so a
  crash mid-save leaves the previous checkpoint whole.

`embedder_train_state_from_numpy` takes a JAX embedder train state held in
memory as numpy arrays instead of on disk, so the port can go on training
from where the JAX trainer stopped.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.models.bridge import bert_params_from_numpy
from symbiont_tpu_torch.train.trainer import (
    TrainState,
    make_embedder_train_state,
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


def _state_tensors(state: TrainState) -> list:
    """The state's leaves in the JAX order: params, count, mu, nu, step
    (count and step as None: they are scalars kept apart)."""
    params = tree_leaves(state.params)
    moments = [state.opt_state[p] for p in params]
    return (params + [None] + [m["exp_avg"] for m in moments]
            + [m["exp_avg_sq"] for m in moments] + [None])


def _adam_count(state: TrainState) -> int:
    params = tree_leaves(state.params)
    return int(state.opt_state[params[0]]["step"]) if params else 0


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
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = [np.asarray(_adam_count(state), np.int32) if t is None else _numpy(t)
              for t in _state_tensors(state)]
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
    into `template` (build it with `make_embedder_train_state` on the same
    geometry): its tensors are overwritten in place. Returns (state, meta).
    Raises ValueError on a leaf-count or per-leaf shape mismatch."""
    path = Path(path)
    spec = json.loads((path / "train_meta.json").read_text())
    with np.load(path / "train_state.npz") as npz:
        leaves = [npz[f"leaf_{i}"] for i in range(spec["n_leaves"])]
    targets = _state_tensors(template)
    if len(targets) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(targets)} — model/optimizer config mismatch")
    # per-leaf shape check: equal leaf counts with different geometry must
    # fail HERE with a clear error, not later as a broadcast error
    for i, (leaf, tmpl) in enumerate(zip(leaves, targets)):
        t_shape = () if tmpl is None else tuple(tmpl.shape)
        if tuple(leaf.shape) != t_shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(leaf.shape)} != template "
                f"shape {t_shape} — model/optimizer config mismatch")
    params = tree_leaves(template.params)
    count = float(leaves[len(params)])
    with torch.no_grad():
        for leaf, tmpl in zip(leaves, targets):
            if tmpl is not None:
                tmpl.copy_(torch.from_numpy(np.array(leaf)))
        for p in params:
            template.opt_state[p]["step"].fill_(count)
    return (TrainState(template.params, template.opt_state, int(leaves[-1])),
            spec.get("meta", {}))


def train_state_exists(path: str | Path) -> bool:
    path = Path(path)
    return ((path / "train_state.npz").exists()
            and (path / "train_meta.json").exists())


def embedder_train_state_from_numpy(params: Params, mu: Params, nu: Params, count: int,
                                    learning_rate: float = 1e-4, device=None):
    """A JAX embedder train state as numpy (params, optax Adam `mu`/`nu` —
    trees shaped like params — and its `count`) → the port's (TrainState,
    AdamW) on CUDA unless `device="cpu"`, with the same masters, moments
    and count, so a step of either package from there takes the same
    update. The step is the count, as in the JAX embedder state."""
    dev = resolve_device(device)
    state, tx = make_embedder_train_state(bert_params_from_numpy(params, dev),
                                          learning_rate)
    moments = zip(tree_leaves(state.params), tree_leaves(bert_params_from_numpy(mu, dev)),
                  tree_leaves(bert_params_from_numpy(nu, dev)), strict=True)
    with torch.no_grad():
        for p, m, n in moments:
            tx.state[p]["exp_avg"].copy_(m)
            tx.state[p]["exp_avg_sq"].copy_(n)
            tx.state[p]["step"].fill_(float(count))
    return state._replace(step=int(count)), tx
