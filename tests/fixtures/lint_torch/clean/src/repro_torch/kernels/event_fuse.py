import torch

from repro_torch.kernels import _build

LAUNCHES = {"scale": 0}


def scale_plain(x):
    return 2.0 * x


def scale(x):
    if x.numel() == 0:
        return torch.zeros_like(x)
    if x.device.type == "cpu":
        return scale_plain(x)
    _build.refuse_grad("scale", x)
    out = torch.empty_like(x)
    LAUNCHES["scale"] += 1
    return out
