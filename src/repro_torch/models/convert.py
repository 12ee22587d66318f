"""The reference's LM parameters over the port's tensors.

The reference keeps parameters as a pytree of arrays: ``embed`` ``[Vp, D]``,
``final_norm`` ``[D]``, ``lm_head`` ``[D, Vp]`` and ``stages``, a tuple with
each stage's per-layer parameters stacked on a leading axis, one entry per
stage of the block program; matrices are ``[in, out]``. A ``dense`` stage
holds ``ln1``, ``attn.{wq,wk,wv,wo}``
(and ``attn.{q_norm,k_norm}`` under qk-norm), ``ln2`` and
``mlp.{w_gate,w_up,w_down}``; a ``zamba_super`` stage holds
``mamba.{ln, mixer.{z_proj, x_proj, bc_proj, dt_proj, conv_w_x, conv_b_x,
conv_w_bc, conv_b_bc, A_log, D, dt_bias, norm_g, out_proj}}`` stacked
``[n_super, mamba_per_super, ...]``, and the tree's ``shared_attn`` holds
the one shared attention block's ``ln1``, ``attn``, ``ln2`` and ``mlp``
(unstacked); an ``xlstm_pair`` stage holds
``mlstm.{ln, mixer.{up_proj, wq, wk, wv, w_if, b_if, norm_g, down_proj}}``
and ``slstm.{ln, mixer.{w_in, r, b, norm_g, out_proj}}``; a ``moe`` stage
holds ``ln1``, ``attn``, ``ln2`` and ``moe.{router, w_gate, w_up, w_down}``
(experts ``[L, E, D, F]``) with, under shared experts,
``moe.shared.{w_gate, w_up, w_down}`` and ``moe.shared_gate``; a ``dec``
stage holds ``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3`` and
``mlp.{w_in, b_in, w_out, b_out}``, and the tree's ``encoder`` holds
``stage`` (``enc`` blocks: ``ln1``, ``attn``, ``ln2``, ``mlp``, stacked)
and ``final_norm``; an ``enc`` stage of the decoder holds the same as an
encoder block, and a standalone ``mamba2``, ``mlstm`` or ``slstm`` stage
``ln`` and ``mixer`` (the mixer's leaves above).

The port holds a tensor a layer (``nn.Linear`` weights ``[out, in]``, the
reference's matrices transposed). :func:`reference_leaves` describes the
reference's leaves over them, once: each :class:`RefLeaf` has the leaf's
path, its stacked shape, the port tensors it stacks (in the order of the
stacked axes) and whether each is transposed. Training runs the
optimizer, the global-norm clip and compression on those leaves, so each
per-leaf decision is the reference's own; :func:`params_to_arrays` gives
the reference's tree as numpy and :func:`params_from_arrays` loads one
(as nested dicts and tuples of numpy arrays, or anything ``numpy.asarray``
reads, bf16 included, through f32, which holds bf16 and f32 values
exactly).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import Transformer, build_model

Path = Tuple[str, ...]
# (path below the block, the tensor of each stacked sub-layer, transposed)
Item = Tuple[Path, List[torch.Tensor], bool]

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")
_MAMBA_LINEAR = ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj")
_MAMBA_ARRAY = ("conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "A_log", "D", "dt_bias",
                "norm_g")
_MLSTM_LINEAR = ("up_proj", "wq", "wk", "wv", "w_if", "down_proj")
_MLSTM_ARRAY = ("b_if", "norm_g")
_SLSTM_LINEAR = ("w_in", "out_proj")
_SLSTM_ARRAY = ("r", "b", "norm_g")


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """One leaf of the reference's parameter tree over the port's tensors."""

    path: Path  # e.g. ("stages", "0", "attn", "wq")
    shape: Tuple[int, ...]  # the reference's (stacked) shape
    tensors: Tuple[torch.Tensor, ...]  # the port tensors, in stacked order
    transposed: bool  # each tensor is the reference's slice transposed

    @property
    def name(self) -> str:
        return ".".join(self.path)

    def stack(self, of: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> torch.Tensor:
        """The leaf in the reference's layout, a new tensor: the port
        tensors themselves, or ``of(tensor)`` of each (their gradients,
        say), transposed where the leaf says and stacked."""
        xs = [t.detach() if of is None else of(t) for t in self.tensors]
        if self.transposed:
            xs = [x.t() for x in xs]
        return torch.stack(xs).reshape(self.shape)

    @torch.no_grad()
    def write(self, value: torch.Tensor) -> None:
        """Copy ``value``, in the reference's layout, into the port tensors."""
        if tuple(value.shape) != self.shape:
            raise ValueError(f"{self.name}: shape {tuple(value.shape)} != {self.shape}")
        one = tuple(self.tensors[0].shape)
        per = value.reshape((len(self.tensors),) + (one[::-1] if self.transposed else one))
        for t, v in zip(self.tensors, per):
            t.copy_(v.t() if self.transposed else v)


def _linears(module, names, prefix: Path = ()) -> List[Item]:
    return [(prefix + (n,), [getattr(module, n).weight], True) for n in names]


def _arrays(module, names, prefix: Path = ()) -> List[Item]:
    return [(prefix + (n,), [getattr(module, n)], False) for n in names]


def _attention_items(attn, prefix: Path) -> List[Item]:
    items = _linears(attn, _ATTN, prefix)
    if attn.q_norm is not None:
        items += _arrays(attn, ("q_norm", "k_norm"), prefix)
    return items


def _mlp_items(mlp, prefix: Path = ("mlp",)) -> List[Item]:
    """A SwiGLU's three matrices, or a GELU MLP's two and their biases."""
    if hasattr(mlp, "w_gate"):
        return _linears(mlp, _MLP, prefix)
    return _linears(mlp, ("w_in", "w_out"), prefix) + [
        (prefix + ("b_in",), [mlp.w_in.bias], False),
        (prefix + ("b_out",), [mlp.w_out.bias], False)]


def _dense_items(block) -> List[Item]:
    """``dense`` and ``enc`` blocks (and zamba2's shared block)."""
    return (_arrays(block, ("ln1", "ln2")) + _attention_items(block.attn, ("attn",))
            + _mlp_items(block.mlp))


def _moe_items(block) -> List[Item]:
    moe = block.moe
    items = (_arrays(block, ("ln1", "ln2")) + _attention_items(block.attn, ("attn",))
             + _arrays(moe, _EXPERTS, ("moe",)))
    if moe.shared is not None:
        items += _linears(moe.shared, _MLP, ("moe", "shared"))
        items += _arrays(moe, ("shared_gate",), ("moe",))
    return items


def _dec_items(block) -> List[Item]:
    return (_arrays(block, ("ln1", "ln2", "ln3"))
            + _attention_items(block.self_attn, ("self_attn",))
            + _attention_items(block.cross_attn, ("cross_attn",)) + _mlp_items(block.mlp))


def _xlstm_items(block) -> List[Item]:
    m, s = ("mlstm", "mixer"), ("slstm", "mixer")
    return ([(("mlstm", "ln"), [block.mlstm_ln], False),
             (("slstm", "ln"), [block.slstm_ln], False)]
            + _linears(block.mlstm, _MLSTM_LINEAR, m) + _arrays(block.mlstm, _MLSTM_ARRAY, m)
            + _linears(block.slstm, _SLSTM_LINEAR, s) + _arrays(block.slstm, _SLSTM_ARRAY, s))


def _mixer_items(block, linear, array, prefix: Path = ()) -> List[Item]:
    """A one-mixer block (``mamba2``, ``mlstm``, ``slstm``): ``ln`` and the
    mixer's matrices ``linear`` and arrays ``array``."""
    return ([(prefix + ("ln",), [block.ln], False)]
            + _linears(block.mixer, linear, prefix + ("mixer",))
            + _arrays(block.mixer, array, prefix + ("mixer",)))


def _zamba_items(block) -> List[Item]:
    """One super-block: each item stacks its ``mamba_per_super`` layers."""
    per_layer = [_mixer_items(layer, _MAMBA_LINEAR, _MAMBA_ARRAY, ("mamba",))
                 for layer in block.mamba]
    return [(path, [items[i][1][0] for items in per_layer], tr)
            for i, (path, _, tr) in enumerate(per_layer[0])]


_ITEMS = {"dense": _dense_items, "moe": _moe_items, "dec": _dec_items, "enc": _dense_items,
          "xlstm_pair": _xlstm_items, "zamba_super": _zamba_items,
          "mamba2": lambda b: _mixer_items(b, _MAMBA_LINEAR, _MAMBA_ARRAY),
          "mlstm": lambda b: _mixer_items(b, _MLSTM_LINEAR, _MLSTM_ARRAY),
          "slstm": lambda b: _mixer_items(b, _SLSTM_LINEAR, _SLSTM_ARRAY)}


def _stage(prefix: Path, blocks, items_of) -> List[RefLeaf]:
    """The stacked leaves of ``blocks``: layer axis first, then a
    super-block's axis of Mamba-2 layers."""
    per_block = [items_of(b) for b in blocks]
    inner = (len(blocks[0].mamba),) if items_of is _zamba_items else ()
    leaves = []
    for i, (path, first, tr) in enumerate(per_block[0]):
        tensors = tuple(t for items in per_block for t in items[i][1])
        one = tuple(first[0].shape)
        shape = (len(blocks),) + inner + (one[::-1] if tr else one)
        leaves.append(RefLeaf(prefix + path, shape, tensors, tr))
    return leaves


def _single(path: Path, tensor: torch.Tensor, transposed: bool) -> RefLeaf:
    shape = tuple(tensor.shape)
    return RefLeaf(path, shape[::-1] if transposed else shape, (tensor,), transposed)


def _pytree_order(leaf: RefLeaf):
    """The reference's pytree order: dict keys sorted, a tuple's entries
    (``stages``) by index."""
    return tuple(int(k) if k.isdigit() else k for k in leaf.path)


def reference_leaves(model: Transformer) -> List[RefLeaf]:
    """The reference's parameter leaves over ``model``'s tensors, in its
    pytree order (dict keys sorted, ``stages`` a tuple)."""
    leaves = [_single(("embed",), model.embed.weight, False),
              _single(("final_norm",), model.final_norm, False),
              _single(("lm_head",), model.lm_head.weight, True)]
    for i, (btype, blocks) in enumerate(model.stages):
        leaves += _stage(("stages", str(i)), blocks, _ITEMS[btype])
    if model.shared_attn is not None:
        leaves += [_single(("shared_attn",) + path, ts[0], tr)
                   for path, ts, tr in _dense_items(model.shared_attn)]
    if model.encoder is not None:
        leaves += _stage(("encoder", "stage"), model.encoder.blocks, _dense_items)
        leaves.append(_single(("encoder", "final_norm"), model.encoder.final_norm, False))
    return sorted(leaves, key=_pytree_order)


def leaves_to_tree(leaves: Sequence[RefLeaf], values: Sequence[Any]) -> Dict[str, Any]:
    """The reference's nested tree (dicts, ``stages`` a tuple) holding
    ``values[i]`` at ``leaves[i]``'s path."""
    tree: Dict[str, Any] = {}
    for leaf, value in zip(leaves, values):
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = value
    tree["stages"] = tuple(tree["stages"][str(i)] for i in range(len(tree["stages"])))
    return tree


def tree_values(leaves: Sequence[RefLeaf], tree) -> List[Any]:
    """The value at each leaf's path of a reference tree (``stages`` a
    tuple or list)."""
    out = []
    for leaf in leaves:
        node = tree
        for key in leaf.path:
            node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
        out.append(node)
    return out


def params_to_arrays(model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`: the reference's parameter
    tree of ``model``, f32 numpy arrays (which hold bf16 values exactly)."""
    leaves = reference_leaves(model)
    return leaves_to_tree(leaves, [leaf.stack().float().cpu().numpy() for leaf in leaves])


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _check_layers(stage, path, n_blocks: int, what: str) -> None:
    first = stage
    for key in path:
        first = first[key]
    if np.shape(first)[0] != n_blocks:
        raise ValueError(f"{what} holds {np.shape(first)[0]} layers, the config {n_blocks}")


# the path of a leaf each stage type holds, and of one it holds alone
_FIRST = {"dense": ("ln1",), "moe": ("ln1",), "dec": ("ln1",), "enc": ("ln1",),
          "zamba_super": ("mamba", "ln"), "xlstm_pair": ("mlstm", "ln"), "mamba2": ("ln",),
          "mlstm": ("ln",), "slstm": ("ln",)}
_OWN = {"dense": ("mlp", "w_gate"), "moe": ("moe", "router"), "dec": ("cross_attn", "wq"),
        "enc": ("mlp", "w_in"), "zamba_super": ("mamba", "mixer", "A_log"),
        "xlstm_pair": ("slstm", "mixer", "r"), "mamba2": ("mixer", "A_log"),
        "mlstm": ("mixer", "w_if"), "slstm": ("mixer", "r")}


def _holds(stage, path) -> bool:
    for key in path:
        if not isinstance(stage, dict) or key not in stage:
            return False
        stage = stage[key]
    return True


def params_from_arrays(cfg: ArchConfig, tree: Dict[str, Any], device: DeviceLike = None,
                       attn_impl: str = "auto", gla_impl: str = "auto") -> Transformer:
    """A :class:`Transformer` on ``device`` holding the reference's
    parameters ``tree``: each stage's stacked leaves are sliced into its
    blocks (a tree whose stages differ from the config's program in number,
    block type or layer count raises ``ValueError``), and matrices are
    transposed into ``nn.Linear`` weights."""
    model = build_model(cfg, device, attn_impl, gla_impl)
    if len(tree["stages"]) != len(model.program):
        raise ValueError(f"the tree holds {len(tree['stages'])} stages, the config's "
                         f"program {len(model.program)}: {model.program}")
    for i, ((btype, blocks), stage) in enumerate(zip(model.stages, tree["stages"])):
        what = f"stages[{i}]"
        if not (_holds(stage, _FIRST[btype]) and _holds(stage, _OWN[btype])):
            raise ValueError(f"{what} is not a {btype!r} stage, the config's program "
                             f"{model.program}")
        _check_layers(stage, _FIRST[btype], len(blocks), what)
        if btype == "moe" and (("shared" in stage["moe"])
                               != (blocks[0].moe.shared is not None)):
            raise ValueError(f"{what}'s shared experts do not match the config's "
                             "n_shared_experts")
        if btype == "zamba_super":
            held, per_super = np.shape(stage["mamba"]["ln"])[1], len(blocks[0].mamba)
            if held != per_super:
                raise ValueError(f"{what} holds {held} Mamba-2 layers a super-block, the "
                                 f"config {per_super}")
    if model.encoder is not None:
        _check_layers(tree["encoder"]["stage"], ("ln1",), len(model.encoder.blocks),
                      "encoder.stage")
    leaves = reference_leaves(model)
    for leaf, value in zip(leaves, tree_values(leaves, tree)):
        leaf.write(_tensor(value))
    return model
