"""The port's default device: its entry points run on the card unless the
caller asks for another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; raises when no CUDA device is present rather
    than running on the host unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda", 0)
    return torch.device(device)
