"""Checkpoints with atomic publish, and versioned RL policy checkpoints —
the part of the reference's ``training/checkpoint.py`` the RL stack needs.

Layout (one directory per step), the reference's byte for byte in its
structure::

    <dir>/step_000123/
        manifest.json          # step, meta, and each leaf's path/file/dtype/shape
        <leaf-path>.npy        # one array file per leaf
    <dir>/LATEST               # atomic pointer file, written last

A step is written into ``step_<n>.tmp-<pid>-<thread>``, renamed into place
(atomic on POSIX), and only then does ``LATEST`` move (a tmp file and a
rename), so a killed writer never publishes a torn checkpoint. A tree is a
nest of dicts, lists and tuples of arrays or tensors; its leaf paths are the
reference's (dict keys in sorted order, list positions, joined by ``.``,
e.g. ``torso.0.w``), so a checkpoint written by either package restores in
the other. Leaves are numpy-native dtypes (policy leaves are f32): a
manifest that names bfloat16 or an fp8 type is refused.

``save_policy`` / ``load_policy`` stamp and check the reference's typed
header (``POLICY_CKPT_VERSION = 2``) with its messages, and carry the
policy as an :class:`~repro_torch.core.rl.networks.ActorCritic`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PyTree = Any

_SEP = "."
_EXOTIC = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def _flatten_with_paths(tree: PyTree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's pytree order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten_with_paths(x, prefix + (str(i),))
        return out
    return [(_SEP.join(prefix) or "ROOT", tree)]


def _unflatten(like: PyTree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _unflatten(x, leaves, prefix + (str(i),)) for i, x in enumerate(like)
        )
    return leaves[_SEP.join(prefix) or "ROOT"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    """Checkpoint writer with atomic publish and bounded retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: PyTree, meta: Optional[Dict] = None) -> None:
        arrays = [(name, _host(x)) for name, x in _flatten_with_paths(tree)]
        self._write(step, arrays, meta or {})

    def _write(self, step: int, arrays, meta: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "meta": meta, "leaves": []}
        for name, arr in arrays:
            fname = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": name, "file": fname, "dtype": str(arr.dtype),
                 "shape": list(arr.shape)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish of the step dir
        ptr_tmp = os.path.join(self.dir, f".LATEST.tmp-{os.getpid()}")
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(final))
        os.rename(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(
            d for d in os.listdir(self.dir)
            if d.startswith("step_") and ".tmp" not in d
        )
        for d in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, like: PyTree, step: Optional[int] = None) -> Tuple[int, PyTree]:
        """Restore into the structure of ``like`` (numpy arrays, shapes
        verified against ``like``'s leaves)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        leaves = {}
        for name, proto in _flatten_with_paths(like):
            e = by_path[name]
            if e["dtype"] in _EXOTIC:
                raise ValueError(
                    f"{name}: checkpoint leaf of dtype {e['dtype']}; the "
                    "PyTorch port restores numpy-native dtypes only"
                )
            arr = np.load(os.path.join(d, e["file"]))
            want = tuple(np.shape(proto))
            if tuple(arr.shape) != want:
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != {want}")
            leaves[name] = arr
        return step, _unflatten(like, leaves)


# --------------------------------------------------------------------------
# Versioned RL policy checkpoints
# --------------------------------------------------------------------------

# version 1: implicit/headerless (pre-hetero, obs 16, global actions only).
# version 2: explicit header with obs/action-space fields.
POLICY_CKPT_VERSION = 2
_POLICY_KIND = "rl-policy"


def save_policy(
    directory: str,
    params,
    *,
    obs_size: int,
    n_actions: int,
    feature: str,
    action: str,
    n_levels: int,
    hidden: Tuple[int, ...] = (128, 128),
    feature_window: int = 8,
    grouped: bool = False,
    n_groups: int = 1,
    dvfs: bool = False,
    step: int = 0,
) -> None:
    """Save an RL policy (an ``ActorCritic``, or the reference's parameter
    tree of arrays) with the versioned header ``load_policy`` checks."""
    from repro_torch.core.convert import policy_params_to_arrays

    if isinstance(params, torch.nn.Module):
        params = policy_params_to_arrays(params)
    meta = {
        "kind": _POLICY_KIND,
        "version": POLICY_CKPT_VERSION,
        "obs_size": int(obs_size),
        "n_actions": int(n_actions),
        "feature": feature,
        "action": action,
        "n_levels": int(n_levels),
        "hidden": [int(h) for h in hidden],
        "feature_window": int(feature_window),
        "grouped": bool(grouped),
        "n_groups": int(n_groups),
        "dvfs": bool(dvfs),
    }
    Checkpointer(directory).save(step, params, meta)


def _policy_meta(directory: str) -> Tuple[int, Dict]:
    ck = Checkpointer(directory)
    step = ck.latest_step()
    if step is None:
        raise FileNotFoundError(f"no policy checkpoint in {directory}")
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    return step, manifest.get("meta") or {}


def _policy_like(obs_size: int, n_actions: int, hidden) -> PyTree:
    def layer(i, o):
        return {"w": np.zeros((i, o), np.float32), "b": np.zeros((o,), np.float32)}

    sizes = (obs_size, *hidden)
    return {
        "torso": [layer(i, o) for i, o in zip(sizes[:-1], sizes[1:])],
        "pi": [layer(hidden[-1], n_actions)],
        "v": [layer(hidden[-1], 1)],
    }


def load_policy(
    directory: str,
    expect_obs_size: Optional[int] = None,
    expect_n_actions: Optional[int] = None,
    device: DeviceLike = None,
):
    """Load a policy saved by :func:`save_policy` (by either package) onto
    ``device`` (``cuda`` unless the caller passes ``"cpu"``), validating its
    header. Returns ``(ActorCritic, meta)``; a headerless checkpoint or an
    observation/action-space mismatch raises ``ValueError`` with the
    reference's migration message."""
    from repro_torch.core.convert import policy_params_from_arrays

    step, meta = _policy_meta(directory)
    if meta.get("kind") != _POLICY_KIND or "version" not in meta:
        raise ValueError(
            f"checkpoint in {directory!r} has no RL-policy header: it "
            "predates checkpoint versioning (pre-heterogeneity, obs-16, "
            "global-action era) and its parameter shapes do not match the "
            "current observation/action spaces. Retrain and re-save with "
            "training.checkpoint.save_policy, or restore the raw tree "
            "manually via Checkpointer.restore if you know its layout."
        )
    if meta["version"] != POLICY_CKPT_VERSION:
        raise ValueError(
            f"RL policy checkpoint version {meta['version']} != supported "
            f"{POLICY_CKPT_VERSION}; retrain or migrate the checkpoint "
            f"({directory!r})"
        )
    if expect_obs_size is not None and meta["obs_size"] != expect_obs_size:
        raise ValueError(
            f"RL policy checkpoint {directory!r} was trained with "
            f"obs_size={meta['obs_size']} (feature {meta['feature']!r}) but "
            f"this run expects obs_size={expect_obs_size} — the observation "
            "space changed (e.g. pre-hetero 16 -> 20); retrain the policy "
            "or run with the checkpoint's feature configuration"
        )
    if expect_n_actions is not None and meta["n_actions"] != expect_n_actions:
        raise ValueError(
            f"RL policy checkpoint {directory!r} has "
            f"n_actions={meta['n_actions']} (action {meta['action']!r}, "
            f"grouped={meta['grouped']}) but this run expects "
            f"{expect_n_actions} — action spaces are incompatible; retrain "
            "or select the checkpoint's action space"
        )
    like = _policy_like(meta["obs_size"], meta["n_actions"], tuple(meta["hidden"]))
    _, tree = Checkpointer(directory).restore(like, step=step)
    return policy_params_from_arrays(tree, device=resolve_device(device)), meta
