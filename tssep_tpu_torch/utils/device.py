"""Device choice for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch

__all__ = ['resolve_device']


def resolve_device(device='cuda') -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    this host has none. There is no silent fall back to the CPU: pass
    ``device='cpu'`` to run there."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run on the CPU")
    return device
