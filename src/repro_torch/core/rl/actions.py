"""Action translators (the paper's Config.py registry) on PyTorch — the
counterpart of the reference's ``core/rl/actions.py``: a discrete action
becomes node power commands for rule 8 (and mode commands for rule 9).

Every translator is ``f(sim_state, const, action, n_levels) -> (on, off)``
or ``-> (on, off, mode)``, where ``on``/``off`` are ``i32[G]`` per-group
command vectors (G from ``sim_state.rl_on_cmd``) and ``mode`` is an
``i32[G]`` DVFS mode-command vector (-1 = leave the group's mode as it is).
:func:`full_commands` normalizes either arity to the triple. Global
translators put the whole command in slot 0 (rule 8's global mode reads
the vector sums); group translators (``GROUP_ACTIONS``) need an
``RLController(grouped=True)`` policy and DVFS translators
(``DVFS_ACTIONS``) an ``RLController(dvfs=True)`` one.

``action`` is a Python int or an integer tensor on the state's device; no
translator reads a device value into Python. Each translator takes one
state (``[N]`` node arrays, a scalar action, ``[G]`` commands out) or a
batch of ``[B]`` rows (the batched RL env's ``[B, N]`` state and its
sweep-shaped ``[B, ...]`` tables, a ``[B]`` action tensor, ``[B, G]``
commands out), row ``b`` of the batch equal to the single state's commands
bit for bit. Per-group counts are int32 ``scatter_add_`` sums, exact in any
order (deterministic on CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ACTIVE, IDLE, SWITCHING_ON

I32 = torch.int32
F32 = torch.float32


def _action(s, action) -> torch.Tensor:
    return torch.as_tensor(action, device=s.t.device).to(I32)


def full_commands(s, ret):
    """Normalize a translator's or controller's return to ``(on, off,
    mode)``; a pair gets an all ``-1`` mode vector (rule 9 leaves every
    mode as it is)."""
    if len(ret) == 2:
        on, off = ret
        return on, off, torch.full_like(s.rl_mode_cmd, -1)
    on, off, mode = ret
    return on, off, torch.as_tensor(mode, device=s.t.device).to(I32)


def _global(s, n_on, n_off):
    """Global scalar commands in slot 0 of the ``[G]`` command vectors."""
    G = s.rl_on_cmd.shape[-1]
    slot0 = torch.arange(G, dtype=torch.int64, device=s.t.device) == 0
    return (torch.where(slot0, n_on.to(I32)[..., None], 0),
            torch.where(slot0, n_off.to(I32)[..., None], 0))


def _on_like(s) -> torch.Tensor:
    """bool[..., N]: nodes powered or powering up."""
    st = s.node_state
    return (st == IDLE) | (st == ACTIVE) | (st == SWITCHING_ON)


def group_counts(group_id, values, G: int) -> torch.Tensor:
    """i32[..., G]: ``values`` (i32[..., N]) summed over each group's nodes
    (the reference's ``zeros(G).at[group_id].add``), exact in any order."""
    out = torch.zeros((*values.shape[:-1], G), dtype=I32, device=values.device)
    gid = group_id.long().expand(values.shape)
    return out.scatter_add_(-1, gid, values)


def delta_nodes(s, const, action, n_levels: int = 5, step_frac: float = 0.125):
    """Symmetric delta: action k in [0, 2*n_levels] toggles
    ``(k - n_levels) * step_frac * N`` nodes (negative = switch off)."""
    N = s.node_state.shape[-1]
    step = max(int(step_frac * N), 1)
    delta = torch.clamp((_action(s, action) - n_levels) * step, -N, N)
    return _global(s, torch.clamp(delta, min=0), torch.clamp(-delta, min=0))


def target_on_fraction(s, const, action, n_levels: int = 9):
    """action k -> target #powered nodes = round(N * k/(n_levels-1));
    the commands bridge the gap from the powered/powering count."""
    N = s.node_state.shape[-1]
    target = torch.round(
        N * _action(s, action).to(F32) / float(n_levels - 1)
    ).to(I32)
    gap = target - _on_like(s).sum(dim=-1, dtype=I32)
    return _global(s, torch.clamp(gap, min=0), torch.clamp(-gap, min=0))


def group_target_fraction(s, const, action, n_levels: int = 9):
    """Group-targeted action space: action = g * n_levels + k sets group g's
    target powered-node count to round(N_g * k/(n_levels-1)); only that
    group receives commands this decision."""
    G = s.rl_on_cmd.shape[-1]
    a = _action(s, action)
    g = torch.clamp(a // n_levels, 0, G - 1)[..., None]
    k = (a % n_levels)[..., None]
    gids = torch.arange(G, dtype=I32, device=a.device)
    on_like = _on_like(s).to(I32)
    group_sizes = group_counts(const.group_id, torch.ones_like(on_like), G)
    on_like_g = group_counts(const.group_id, on_like, G)
    target = torch.round(
        group_sizes.to(F32) * k.to(F32) / float(n_levels - 1)
    ).to(I32)
    gap = torch.where(gids == g, target - on_like_g, 0)
    return torch.clamp(gap, min=0), torch.clamp(-gap, min=0)


def group_mode(s, const, action, n_levels: int):
    """DVFS action space (rule 9): action = g * n_levels + k commands group
    g's mode to k this decision; the other groups keep theirs (-1).
    ``n_levels`` is the platform's mode-table width
    (``PlatformSpec.n_dvfs_modes()``); rule 9 clamps k per group. Emits no
    on/off commands."""
    G = s.rl_on_cmd.shape[-1]
    a = _action(s, action)
    g = torch.clamp(a // n_levels, 0, G - 1)[..., None]
    k = (a % n_levels)[..., None]
    gids = torch.arange(G, dtype=I32, device=a.device)
    mode = torch.where(gids == g, k, -1).to(I32)
    zeros = torch.zeros_like(s.rl_on_cmd)
    return zeros, zeros, mode


ACTION_TRANSLATORS = {
    "delta": delta_nodes,
    "target_fraction": target_on_fraction,
    "group_target_fraction": group_target_fraction,
    "group_mode": group_mode,
}

# translators whose commands are per group (need RLController(grouped=True))
GROUP_ACTIONS = frozenset({"group_target_fraction"})
# translators that command DVFS modes (need RLController(dvfs=True);
# n_levels must equal the platform's mode-table width)
DVFS_ACTIONS = frozenset({"group_mode"})


def action_space_size(name: str, n_levels: int = None, n_groups: int = 1) -> int:
    if name == "delta":
        return 2 * (n_levels or 5) + 1
    if name == "target_fraction":
        return n_levels or 9
    if name == "group_target_fraction":
        return n_groups * (n_levels or 9)
    if name == "group_mode":
        if not n_levels:
            raise ValueError(
                "group_mode needs n_levels = the platform's DVFS mode-table "
                "width (PlatformSpec.n_dvfs_modes())"
            )
        return n_groups * n_levels
    raise KeyError(name)
