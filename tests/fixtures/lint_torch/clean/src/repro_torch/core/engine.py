import torch


def make_const(platform, config):
    return torch.tensor(config.timeout_or_inf, dtype=torch.int32)


def _complete_jobs(s):
    order = torch.argsort(s.key, stable=True)
    return order, torch.arange(4, dtype=torch.int32)


def run_sim(s, const, cfg, max_batches):
    return _complete_jobs(s)
