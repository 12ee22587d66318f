def make_const(platform, config):
    return config.shinier_tables


def run_sim(s, const, cfg, max_batches):
    return s
