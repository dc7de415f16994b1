"""Device resolution shared by every entry point of the port.

`device=None` means the first CUDA card.  Without CUDA an entry point
raises unless the caller asked for the CPU by name: the port never
carries on silently on the host when a card was expected.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> "cuda"; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return dev
