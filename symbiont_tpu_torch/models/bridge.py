"""Parameter trees from the JAX package into the port.

`bert_params_from_numpy` and `gpt_params_from_numpy` take a JAX BERT or GPT
parameter tree after `np.asarray` on every leaf (the same nested dict,
`"layers"` a list) and return the port's tree of tensors on the device,
same keys, same `[in, out]` layout and dtypes. The port never imports JAX: the caller turns JAX arrays into
numpy. A quantized leaf (the JAX package's `QuantTensor` after `np.asarray`
on its `q` and `scale`, or anything else with those two fields) becomes the
port's `quant.QuantTensor`, its int8 or float8_e4m3fn codes bit for bit. A
JAX train state is carried across by
`train.checkpoint.embedder_train_state_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from symbiont_tpu_torch.device import resolve_device
from symbiont_tpu_torch.models.bert import tree_map
from symbiont_tpu_torch.models.quant import QuantTensor


def _tensor(a, device):
    if hasattr(a, "q") and hasattr(a, "scale"):
        return QuantTensor(_tensor(a.q, device), _tensor(a.scale, device))
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":  # nor has ml_dtypes' fp8: move the bits
        bits = torch.from_numpy(np.array(a.view(np.uint8), order="C"))
        return bits.view(torch.float8_e4m3fn).to(device)
    # a C-ordered copy: JAX's arrays are read-only, a converted kernel is a
    # transposed view
    return torch.from_numpy(np.array(a, order="C")).to(device)


def bert_params_from_numpy(tree, device=None):
    """Nested dict/list of numpy arrays → the same tree of torch tensors,
    on CUDA unless `device="cpu"` (`device.resolve_device`)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def gpt_params_from_numpy(tree, device=None):
    """The JAX GPT tree (`models/gpt.py`'s layout, leaves as numpy) → the
    port's `models.gpt` tree, by the rules of `bert_params_from_numpy`."""
    return bert_params_from_numpy(tree, device)
