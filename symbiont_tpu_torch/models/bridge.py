"""Parameter trees from the JAX package into the port.

`bert_params_from_numpy` takes a JAX BERT parameter tree after `np.asarray`
on every leaf (the same nested dict, `"layers"` a list) and returns the
port's tree of tensors on `device`, same keys, same `[in, out]` layout and
dtypes. The port never imports JAX: the caller turns JAX arrays into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from symbiont_tpu_torch.models.bert import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's are read-only


def bert_params_from_numpy(tree, device="cpu"):
    """Nested dict/list of numpy arrays → the same tree of torch tensors."""
    return tree_map(lambda a: _tensor(a, device), tree)
