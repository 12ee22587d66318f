"""Parameter and activation partition rules — the reference's
``models/sharding.py`` without JAX.

Mesh axes: ``("data", "model")`` single-pod (16x16) or ``("pod", "data",
"model")`` multi-pod (2x16x16). Batch shards over ("pod", "data");
tensor-parallel dims over "model" (Megatron pairing: column-parallel then
row-parallel, so each block needs one reduce); with ``cfg.fsdp`` the
complementary weight dim also shards over "data" (ZeRO-3-style).

Rules are name/shape driven over the reference's parameter leaves (stacked
leading stage axes are skipped). Any dim that does not divide its mesh axis
falls back to replication (e.g. glm4's 2 KV heads vs the 16-way model
axis).

The port's types for the reference's:

* a mesh is a plain ordered mapping of axis name to size, such as
  ``{"data": 16, "model": 16}`` (a ``shard.Mesh`` works too: its ``shape``
  is one); only its sizes are read, so no device is needed;
* a spec is a :class:`P` (the reference's ``PartitionSpec``), a tuple with
  one entry a dim: None, an axis name, or a tuple of axis names; a tree of
  specs keeps each :class:`P` as a leaf;
* a parameter is a :class:`~repro_torch.models.convert.RefLeaf`, whose path
  joined by ``/`` is the reference's tree path (``stages/0/attn/wq``) and
  whose ``shape`` is the reference's stacked shape (:func:`params_specs`);
* batch and cache trees are the port's (dicts, named tuples), mapped tensor
  by tensor.

Beside the rules: :func:`mesh_coords` (a rank's coordinates, row-major as
``jax.make_mesh`` lays devices out), :func:`shard_of` (the block of a full
tensor at those coordinates), :func:`unshard` (its inverse: a full tensor
from its blocks) and :func:`sharded_bytes` (the reference dry run's
``_sharded_bytes``: per-device bytes under specs).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree

from repro_torch.configs.base import ArchConfig

Axis = Union[None, str, Tuple[str, ...]]
PyTree = Any


class P(tuple):
    """A partition spec: ``P(None, "model")``; ``P()`` replicates. A tuple
    subclass, so ``tuple(spec)`` equals the reference's ``tuple`` of its
    ``PartitionSpec``, and a leaf of a pytree (``torch.utils._pytree``
    registers ``tuple`` itself only)."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Spec = P


def _axes(mesh) -> Mapping[str, int]:
    """The mesh's axis sizes: a mapping, or an object's ``shape`` mapping."""
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError(f"a mesh is a mapping of axis name to size, got {mesh!r}")
    return shape


def _axis_size(mesh, name: str) -> int:
    axes = _axes(mesh)
    return axes[name] if name in axes else 1


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes used for batch/data parallelism ('pod' folds into data)."""
    return tuple(a for a in ("pod", "data") if a in _axes(mesh))


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _div(n: int, mesh, axis) -> bool:
    if isinstance(axis, tuple):
        size = _prod(_axis_size(mesh, a) for a in axis)
    else:
        size = _axis_size(mesh, axis)
    return n % size == 0 and n >= size


# 2D weight rule: (in_dim -> fsdp/'data', out_dim -> 'model') or transposed
def _matmul_spec(shape, mesh, cfg: ArchConfig, model_dim: Optional[int],
                 fsdp_dim: Optional[int]) -> Spec:
    """A spec for an nD weight; only the trailing 2 dims (or named dims) are
    sharded, leading stage-stack dims replicate."""
    spec: List[Axis] = [None] * len(shape)
    if model_dim is not None and _div(shape[model_dim], mesh, "model"):
        spec[model_dim] = "model"
    if cfg.fsdp and fsdp_dim is not None and _div(shape[fsdp_dim], mesh, "data"):
        spec[fsdp_dim] = "data"
    return P(*spec)


def zero_sp_param_spec(cfg: ArchConfig, mesh, shape) -> Spec:
    """fsdp_sp layout for matmul weights: contraction dim (-2) over 'model'
    (the weight is all-gathered per layer, ZeRO-style, instead of
    all-reducing full activations), optional ZeRO over 'data' on dim -1."""
    spec: List[Axis] = [None] * len(shape)
    if _div(shape[-2], mesh, "model"):
        spec[-2] = "model"
    if cfg.fsdp and _div(shape[-1], mesh, "data"):
        spec[-1] = "data"
    return P(*spec)


def param_spec(cfg: ArchConfig, mesh, path: str, shape) -> Spec:
    """The spec of one parameter leaf, from its tree path and shape."""
    nd = len(shape)
    name_ = path.split("/")[-1]
    if (
        cfg.sharding_mode == "fsdp_sp"
        and nd >= 2
        and name_ not in ("embed", "lm_head")
        and "mixer" not in path
        and name_ != "r"
    ):
        return zero_sp_param_spec(cfg, mesh, shape)
    last, prev = nd - 1, nd - 2

    def ms(model_dim, fsdp_dim):
        return _matmul_spec(shape, mesh, cfg, model_dim, fsdp_dim)

    name = path.split("/")[-1]
    if nd <= 1:
        return P()
    # embeddings / unembedding
    if name == "embed":
        return ms(0, 1)  # (Vp, D): vocab over model
    if name == "lm_head":
        return ms(last, prev)  # (D, Vp): vocab over model
    # attention projections
    if name in ("wq", "wk", "wv"):
        return ms(last, prev)
    if name == "wo":
        return ms(prev, last)
    # dense MLPs (swiglu / gelu): column then row parallel
    if name in ("w_gate", "w_up", "w_in"):
        return ms(last, prev)
    if "moe" in path and name == "w_down" and not cfg.fsdp:
        # MoE down-projection: model on the OUTPUT dim (row-parallel would
        # all-reduce the padded capacity buffer); not under fsdp, where the
        # two operands' contraction dims would shard over different axes
        return ms(last, prev)
    if name in ("w_down", "w_out"):
        return ms(prev, last)
    # MoE: experts stay replicated on the expert dim; per-expert matrices
    # shard like dense MLPs on their trailing dims
    if name == "router":
        return P()
    # mamba2 mixer: z/x column-parallel, conv-x channels follow, out_proj
    # row-parallel; B/C/dt projections and per-head scalars replicated
    if name in ("z_proj", "x_proj"):
        return ms(last, prev)
    if name == "conv_w_x":
        return ms(last, None)
    if name in ("bc_proj", "dt_proj", "conv_w_bc"):
        return P()
    if "mixer" in path and name == "out_proj":
        return ms(prev, last)
    # xlstm mixers: recurrent block-diagonal weights stay replicated
    if "mixer" in path or name in ("r",):
        return P()
    if name in ("up_proj",):
        return ms(last, prev)
    if name in ("down_proj", "out_proj"):
        return ms(prev, last)
    return P()


def leaf_path(leaf) -> str:
    """A :class:`~repro_torch.models.convert.RefLeaf`'s reference tree path
    (``stages/0/attn/wq``)."""
    return "/".join(leaf.path)


def params_specs(cfg: ArchConfig, mesh, leaves: Sequence[Any]) -> List[Spec]:
    """The spec of each reference leaf (``convert.reference_leaves``), in
    their order: the reference's ``params_shardings``."""
    return [param_spec(cfg, mesh, leaf_path(leaf), leaf.shape) for leaf in leaves]


def params_shardings(cfg: ArchConfig, mesh, params_shapes: PyTree) -> PyTree:
    """The spec of every leaf of a reference parameter tree (nested dicts,
    ``stages`` a tuple or list; leaves anything with a ``shape``: tensors,
    numpy arrays), as a tree of the same structure; a leaf's path is its
    keys and positions joined by ``/``."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        return param_spec(cfg, mesh, "/".join(path), tuple(node.shape))

    return walk(params_shapes, ())


def _map_tensors(fn, tree: PyTree) -> PyTree:
    return _pytree.tree_map_only(torch.Tensor, fn, tree)


def batch_spec(mesh, ndim: int, shard_seq_axis: Optional[int] = None) -> Spec:
    """Batch tensors: axis 0 over ('pod','data')."""
    spec: List[Axis] = [None] * ndim
    spec[0] = data_axes(mesh)
    if shard_seq_axis is not None:
        spec[0] = None
        spec[shard_seq_axis] = data_axes(mesh)
    return P(*spec)


def batch_shardings(mesh, batch_shapes: PyTree, batch_size: int,
                    seq_over_model: bool = False) -> PyTree:
    """Shard batch dim over data axes; batch=1 (long-context) falls back to
    replicated batch (sequence sharding is applied to the cache instead).
    ``seq_over_model`` (the fsdp_sp layout): also shard the sequence axis
    (dim 1) over the model axis."""
    dp = _prod(_axis_size(mesh, a) for a in data_axes(mesh))
    axes = _axes(mesh)

    def leaf(x):
        if x.ndim >= 1 and x.shape[0] == batch_size and batch_size % dp == 0:
            spec: List[Axis] = [None] * x.ndim
            spec[0] = data_axes(mesh)
            if (
                seq_over_model
                and x.ndim >= 2
                and "model" in axes
                and x.shape[1] % axes["model"] == 0
            ):
                spec[1] = "model"
            return P(*spec)
        return P()

    return _map_tensors(leaf, batch_shapes)


def cache_shardings(cfg: ArchConfig, mesh, cache_shapes: PyTree, batch_size: int,
                    seq_len: int) -> PyTree:
    """KV caches / SSM states. Batch shards over data when divisible; for
    batch=1 long-context decode the *sequence* axis shards over data instead
    (context parallelism), and the model axis shards KV heads when
    divisible."""
    dp = _prod(_axis_size(mesh, a) for a in data_axes(mesh))
    dax = data_axes(mesh)

    def leaf(x):
        spec: List[Axis] = [None] * x.ndim
        # find batch axis: first axis == batch_size after the stage-stack axis
        baxis = None
        for i, s in enumerate(x.shape[:3]):
            if s == batch_size:
                baxis = i
                break
        if baxis is not None and batch_size % dp == 0 and batch_size >= dp:
            spec[baxis] = dax
        elif baxis is not None:
            # context parallel: shard the (long) sequence axis
            for i in range(baxis + 1, x.ndim):
                if x.shape[i] == seq_len and seq_len % dp == 0:
                    spec[i] = dax
                    break
        # shard KV heads over model where divisible (axis sized n_kv_heads)
        for i in range(x.ndim - 2, x.ndim):
            if (
                i > (baxis or 0)
                and x.shape[i] == cfg.n_kv_heads
                and _div(cfg.n_kv_heads, mesh, "model")
                and spec[i] is None
            ):
                spec[i] = "model"
                break
        return P(*spec)

    return _map_tensors(leaf, cache_shapes)


def replicated(mesh, shapes: PyTree) -> PyTree:
    return _map_tensors(lambda _: P(), shapes)


# ---------------------------------------------------------------------------
# blocks at a rank, and back
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis, row-major over the mesh's
    axes (the last axis fastest, as ``jax.make_mesh`` lays out devices)."""
    axes = _axes(mesh)
    n = _prod(axes.values())
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    out: Dict[str, int] = {}
    for name in reversed(list(axes)):
        rank, out[name] = divmod(rank, axes[name])
    return {name: out[name] for name in axes}


def _block(mesh, axis: Axis, coords: Mapping[str, int]) -> Tuple[int, int]:
    """(index of the block, number of blocks) of ``coords`` along a spec
    entry's axes (a tuple of axes major to minor)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    idx, k = 0, 1
    for a in names:
        idx, k = idx * _axis_size(mesh, a) + coords.get(a, 0), k * _axis_size(mesh, a)
    return idx, k


def shard_of(x: torch.Tensor, spec: Spec, mesh, coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``x`` that the rank at ``coords`` holds under ``spec``
    (a view); a sharded dim that does not divide raises ``ValueError``."""
    for dim, axis in enumerate(spec):
        if axis is None or (isinstance(axis, tuple) and not axis):
            continue
        idx, k = _block(mesh, axis, coords)
        if x.shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {k} ways "
                             f"over {axis!r}")
        n = x.shape[dim] // k
        x = x.narrow(dim, idx * n, n)
    return x


def unshard(blocks: Mapping[int, torch.Tensor], spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from its blocks, ``{rank: block}`` (the inverse of
    :func:`shard_of`). Ranks that hold a copy of another's block may be left
    out; a block missing from the full tensor raises ``ValueError``."""
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    ks = []
    for dim, axis in enumerate(spec):
        if axis is None or (isinstance(axis, tuple) and not axis):
            continue
        _, k = _block(mesh, axis, {})
        shape[dim] *= k
        ks.append((dim, axis, k))
    out = first.new_empty(shape)
    seen = set()
    for rank, piece in blocks.items():
        coords = mesh_coords(mesh, rank)
        view, key = out, []
        for dim, axis, _ in ks:
            idx, _ = _block(mesh, axis, coords)
            n = piece.shape[dim]
            view = view.narrow(dim, idx * n, n)
            key.append(idx)
        view.copy_(piece)
        seen.add(tuple(key))
    want = set(itertools.product(*(range(k) for _, _, k in ks)))
    if seen != want:
        raise ValueError(f"blocks {sorted(want - seen)} of a {tuple(shape)} tensor are missing")
    return out


def sharded_bytes(shapes: PyTree, specs: PyTree, mesh) -> int:
    """Per-device bytes of the tensors of ``shapes`` (fake, meta or real)
    under ``specs``, a tree of the same structure with a :class:`P` for each
    tensor: the reference dry run's ``_sharded_bytes``, which counts a dim
    whose size does not divide its axes whole."""
    xs = [x for x in _pytree.tree_leaves(shapes) if isinstance(x, torch.Tensor)]
    ss = [s for s in _pytree.tree_leaves(specs) if isinstance(s, P)]
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} tensors against {len(ss)} specs")
    total = 0
    for x, spec in zip(xs, ss):
        n_shards = 1
        for i, axis in enumerate(spec):
            if axis is None:
                continue
            names = axis if isinstance(axis, tuple) else (axis,)
            k = _prod(_axis_size(mesh, a) for a in names)
            if i < x.ndim and x.shape[i] % k == 0:
                n_shards *= k
        total += x.numel() * x.element_size() // n_shards
    return total
