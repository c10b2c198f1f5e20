"""Device selection shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: `device=None`
means CUDA, and without a card that is an error, never a silent fallback.
`to_device` moves host data to a device without making the host wait for
the card.
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


def to_device(t, device) -> torch.Tensor:
    """A host tensor or numpy array on `device`. To a card it is staged in
    page-locked memory and copied on the current stream without a wait: a
    plain copy from pageable memory first waits for all work queued on the
    stream, which would stall the host behind the batches in flight.
    Page-locked memory is not touched on the CPU (a CPU-only build has
    none)."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(t)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
