"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back to it quietly."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (the
    ``jax.block_until_ready`` of the port); a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
