"""The torch device every public entry point of the port runs on.

Entry points take ``device="cuda"`` by default; without a card that
raises, and nothing falls back to the CPU.  ``device="cpu"`` runs the
kernels' plain PyTorch versions on purpose (the tests do).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, checked: CUDA must be available when it
    is asked for, and only cpu and cuda are taken."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
