"""Device resolution for the port's entry points: the card by default,
the CPU only when the caller asks for it. No silent fallback."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the "
            "plain torch versions on the CPU")
    return dev
