"""Parameter trees from the JAX package into the port.

`bert_params_from_numpy` takes a JAX BERT parameter tree after `np.asarray`
on every leaf (the same nested dict, `"layers"` a list) and returns the
port's tree of tensors on the device, same keys, same `[in, out]` layout
and dtypes. The port never imports JAX: the caller turns JAX arrays into
numpy. A JAX train state is carried across by
`train.checkpoint.embedder_train_state_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.models.bert import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's are read-only


def bert_params_from_numpy(tree, device=None):
    """Nested dict/list of numpy arrays → the same tree of torch tensors,
    on CUDA unless `device="cpu"` (`device.resolve_device`)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)
