import torch

LAUNCHES = {"scan": 0, "twice": 0}


def _launch(name, x):
    LAUNCHES[name] += 1
    return x


def scan_plain(x):
    return x.cumsum(0)


def scan(x):
    try:
        return _launch("scan", x)
    except RuntimeError:
        return scan_plain(x)


def twice(x):
    if x.numel() == 0:
        return x
    return _launch("twice", x)
