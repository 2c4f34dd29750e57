"""The port's device rule.

Entry points take ``device=None``, which means the CUDA card.  Without a card
they raise: nothing drops quietly to the CPU.  Callers that want the CPU (the
tests) say so with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises if that device is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "isdf_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def check_on(dev: torch.device, **tensors) -> None:
    """Raise if any tensor lies on another device than ``dev``."""
    for name, t in tensors.items():
        if t.device.type != dev.type:
            raise ValueError(
                f"{name} is on {t.device}, expected {dev}")
