"""RL extension of the simulator on PyTorch (the paper's HPCGymEnv and its
Config.py registries) — the counterpart of the reference's ``core/rl``.

The env is a pair of pure functions (``env_reset`` / ``env_step``) over
:class:`EnvState`, with a batched twin over ``[B]`` rows
(``batched_reset`` / ``batched_step``) on the sweep's tables; the feature
extractors, action translators and rewards are registries; the learners
(A2C, PPO, the A2C curriculum) train an actor-critic MLP with autograd.

The names below are the reference's exports, loaded on first use: the
engine imports ``actions`` from this package, and ``env`` imports the
engine, so an eager import here would be circular.
"""
import importlib

_EXPORTS = {
    "EnvConfig": "env",
    "EnvState": "env",
    "HPCGymEnv": "env",
    "env_reset": "env",
    "env_step": "env",
    "FEATURE_EXTRACTORS": "features",
    "feature_size": "features",
    "ACTION_TRANSLATORS": "actions",
    "action_space_size": "actions",
    "REWARDS": "rewards",
    "mlp_init": "networks",
    "mlp_apply": "networks",
    "policy_init": "networks",
    "policy_apply": "networks",
    "A2CConfig": "a2c",
    "train_a2c": "a2c",
    "PPOConfig": "ppo",
    "train_ppo": "ppo",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
