import torch


def route(logits):
    return torch.argsort(logits, dim=-1, stable=True)
