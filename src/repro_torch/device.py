"""Where the port's tensors live.

Entry points default to the card.  Running on the CPU is something the
caller asks for by name (``device="cpu"``, as the tests do); a missing card
is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve"]

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raising when there is no card); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
