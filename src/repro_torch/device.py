"""Device resolution for the port's entry points.

Entry points (``init_params``, ``DecodeSession``) run on the card unless
the caller names another device.  Without a card and without an explicit
device they raise: nothing falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig`` dtype string -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}[name]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (
        b.index if b.index is not None else cur)


def check_device(t: torch.Tensor, device: Optional[torch.device],
                 what: str) -> None:
    if device is not None and not same_device(t.device, device):
        raise ValueError(f"{what} lies on {t.device}, expected {device}")
