from repro_torch.core import engine


def _static_trace_key(platform, config, J, cap, device):
    return (config.window, J, cap)


def _pass(cfg):
    if cfg.shiny:
        return 1
    return cfg.window


def sweep_async(platform, workload, scenarios, config=None):
    const = engine.make_const(platform, config)
    return engine.run_sim(_pass(config), const, config, 1)


def sweep(platform, workload, scenarios, config=None):
    return sweep_async(platform, workload, scenarios, config)
