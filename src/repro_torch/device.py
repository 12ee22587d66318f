"""Device selection for the port's entry points.

The port runs on the CUDA device. The CPU is a deliberate choice of the
caller (the tests, debugging on a laptop), never a silent fallback: without a
CUDA device and without an explicit ``"cpu"``, the entry points raise.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; an explicit device passes through.

    Raises RuntimeError when CUDA is asked for (or implied) but absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "PyTorch engine on the CPU explicitly"
        )
    return dev
