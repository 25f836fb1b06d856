"""Where the port computes: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — the
    port never carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {device}")
    return device
