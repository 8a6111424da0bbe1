"""The entry points' device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None, who: str = "avatarclip_torch") -> torch.device:
    """``device`` as a torch.device, CUDA when None; raises when CUDA is
    asked for and there is no card (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA was asked for but torch.cuda.is_available() is false; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
