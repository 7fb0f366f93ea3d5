"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None → CUDA (raises when there is no card); anything else is taken
    as given, so `device="cpu"` selects the plain PyTorch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
