"""Device selection shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: `device=None`
means CUDA, and without a card that is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda (raises without a card); "cpu"/"cuda"/torch.device
    pass through, a CUDA request without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
