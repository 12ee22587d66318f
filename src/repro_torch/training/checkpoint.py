"""Checkpoints with async writes and atomic publish, and versioned RL
policy checkpoints — the reference's ``training/checkpoint.py``.

Layout (one directory per step), the reference's byte for byte in its
structure::

    <dir>/step_000123/
        manifest.json          # step, meta, and each leaf's path/file/dtype/shape
        <leaf-path>.npy        # one array file per leaf
    <dir>/LATEST               # atomic pointer file, written last

A step is written into ``step_<n>.tmp-<pid>-<thread>``, renamed into place
(atomic on POSIX), and only then does ``LATEST`` move (a tmp file and a
rename), so a killed writer never publishes a torn checkpoint.
``save_async`` copies every leaf to the host on the caller and writes on a
daemon thread; the next save (or ``wait()``) joins it and re-raises the
writer's error.

A tree is a nest of dicts, NamedTuples, lists and tuples of arrays or
tensors; ``None`` is an empty subtree. Its leaf paths are the reference's:
dict keys in sorted order, NamedTuple field names, list and tuple
positions, joined by ``.`` (``torso.0.w``, ``opt.inner.mu.stages.0.ln1``),
so a checkpoint written by either package restores in the other. bf16
leaves are stored as the reference stores them: a ``uint16`` view, with
``"bfloat16"`` as the manifest's dtype. They restore as bf16 tensors where
``like``'s leaf is a torch tensor, and are refused by name where it is a
numpy array (numpy has no bf16); every other leaf restores as a numpy
array. A manifest that names an fp8 type is refused.

``save_policy`` / ``load_policy`` stamp and check the reference's typed
header (``POLICY_CKPT_VERSION = 2``) with its messages, and carry the
policy as an :class:`~repro_torch.core.rl.networks.ActorCritic`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

PyTree = Any

_SEP = "."
_BF16 = "bfloat16"
_FP8 = ("float8_e4m3fn", "float8_e5m2")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(key, subtree) pairs in the reference's order, or [] for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return []


def _flatten_with_paths(tree: PyTree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        out = []
        for key, sub in _children(tree):
            out += _flatten_with_paths(sub, prefix + (key,))
        return out
    return [(_SEP.join(prefix) or "ROOT", tree)]


def _unflatten(like: PyTree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, prefix + (str(k),)) for k in like}
    if isinstance(like, (list, tuple)):
        subs = [_unflatten(x, leaves, prefix + (key,)) for key, x in _children(like)]
        return type(like)._make(subs) if _is_namedtuple(like) else type(like)(subs)
    return leaves[_SEP.join(prefix) or "ROOT"]


def _host(x) -> Tuple[np.ndarray, str]:
    """(a host copy of the leaf as written to disk, the manifest's dtype): a
    bf16 tensor as its ``uint16`` view, named ``"bfloat16"``. A copy, so
    that the caller may update its tensors while ``save_async`` writes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = x.numpy()
    else:
        arr = np.array(x)
    return arr, str(arr.dtype)


def _from_disk(arr: np.ndarray, dtype: str):
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


class Checkpointer:
    """Checkpoint writer with atomic publish and bounded retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, meta: Optional[Dict] = None) -> None:
        """Blocking save (the worker of ``save_async`` writes the same way)."""
        arrays = [(name, *_host(x)) for name, x in _flatten_with_paths(tree)]
        self._write(step, arrays, meta or {})

    def save_async(self, step: int, tree: PyTree, meta: Optional[Dict] = None) -> None:
        """Host copies on the caller, file I/O on a daemon thread; one write
        outstanding at a time."""
        self.wait()
        arrays = [(name, *_host(x)) for name, x in _flatten_with_paths(tree)]
        m = dict(meta or {})

        def worker():
            try:
                self._write(step, arrays, m)
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the outstanding write and re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, arrays, meta: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "meta": meta, "leaves": []}
        for name, arr, dtype in arrays:
            fname = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": name, "file": fname, "dtype": dtype, "shape": list(arr.shape)}
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
        """Restore into the structure of ``like``, whose leaves give the
        shapes (verified): numpy arrays, bf16 leaves as bf16 tensors (where
        ``like``'s leaf is a tensor)."""
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
            if e["dtype"] in _FP8 or (e["dtype"] == _BF16
                                      and not isinstance(proto, torch.Tensor)):
                raise ValueError(
                    f"{name}: checkpoint leaf of dtype {e['dtype']}; the PyTorch "
                    "port restores numpy dtypes, and bfloat16 into a leaf that "
                    "is a torch tensor (numpy has no bfloat16)"
                )
            arr = np.load(os.path.join(d, e["file"]))
            want = tuple(proto.shape) if hasattr(proto, "shape") else np.shape(proto)
            if tuple(arr.shape) != want:
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != {want}")
            leaves[name] = _from_disk(arr, e["dtype"])
        return step, _unflatten(like, leaves)


def restore_or_init(ckpt: Checkpointer, init_fn: Callable[[], PyTree]) -> Tuple[int, PyTree]:
    """Restart from the latest checkpoint, or ``(0, init_fn())`` when there
    is none: the launcher's crash-recovery entry point. ``init_fn()`` also
    gives the structure and shapes a restore reads into."""
    step = ckpt.latest_step()
    if step is None:
        return 0, init_fn()
    return ckpt.restore(init_fn(), step=step)


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
