from repro_torch.core import engine
from repro_torch.core.engine import make_const


def _static_trace_key(platform, config, J, cap, device):
    return (config.window, config.node_order, J, cap)


def _rows(config):
    return config.window + 1


def sweep_async(platform, workload, scenarios, config=None):
    const = make_const(platform, config)
    key = _static_trace_key(platform, config, 1, config.max_batches, None)
    return engine.run_sim(None, const, config, _rows(config)), key


def sweep(platform, workload, scenarios, config=None):
    return sweep_async(platform, workload, scenarios, config)
