import torch


def _order(key):
    # spars-lint: ignore[PL005] values only: equal values sort to the same list
    return torch.sort(key).values


def _debug(x):
    import jax  # spars-lint: ignore[PL001] a fixture's seeded, waived violation

    return jax, torch.arange(3)  # spars-lint: ignore[PL005, PL001] a comma list
