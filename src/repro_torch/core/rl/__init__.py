"""RL layer of the PyTorch port: so far the action translators
(:mod:`repro_torch.core.rl.actions`), which an in-graph controller uses to
turn a discrete action into rule 8/9 commands. The features, networks,
environment and learners are ROADMAP Queue 1 item 10."""
