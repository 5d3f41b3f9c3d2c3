"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a card raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "s2v_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode on (not
    ``no_grad``, not ``inference_mode``) and one of them requiring a
    gradient.  Kernels without a backward run only when it is False."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
