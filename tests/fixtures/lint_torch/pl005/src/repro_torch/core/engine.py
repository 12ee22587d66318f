import numpy as np
import torch


def _order(s, key):
    first = torch.argsort(key)
    second = key.sort(dim=-1)
    third = np.argsort(np.asarray(s))
    return first, second, third, torch.arange(8)
