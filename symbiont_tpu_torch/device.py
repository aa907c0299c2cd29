"""The one place the port decides which device it runs on."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   force_cpu: bool = False) -> torch.device:
    """CUDA unless the caller asks for the CPU (`device="cpu"` or
    `force_cpu`). Raises when CUDA is wanted and absent: the port never
    carries on on the CPU behind a caller's back.

    Also turns TF32 off for float32 matmuls and convolutions: TF32 keeps
    about three decimal digits, the Hopper counterpart of the single-pass
    bf16 hazard the JAX kernel guards against with `_dot_prec`, and the
    float32 parity bars (atol 2e-5) need full float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if force_cpu or dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or EngineConfig.force_cpu) to run on the CPU")
    return dev
