"""Carry the reference's LM parameters into the port.

The reference keeps parameters as a pytree of arrays: ``embed`` ``[Vp, D]``,
``final_norm`` ``[D]``, ``lm_head`` ``[D, Vp]`` and ``stages[0]``, the
stage's per-layer parameters stacked on a leading axis; matrices are
``[in, out]``. A ``dense`` stage holds ``ln1``, ``attn.{wq,wk,wv,wo}``
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
and ``final_norm``. Here that tree
comes as nested dicts and tuples of numpy arrays (or anything
``numpy.asarray`` reads, bf16 included), and goes through f32, which holds
bf16 and f32 values exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import Transformer, build_model

_ATTN = ("wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_MLP = ("w_gate", "w_up", "w_down")
_GELU = ("w_in", "w_out")
_EXPERTS = ("router", "w_gate", "w_up", "w_down")
_MAMBA_LINEAR = ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj")
_MAMBA_ARRAY = ("conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "A_log", "D", "dt_bias",
                "norm_g")
_MLSTM_LINEAR = ("up_proj", "wq", "wk", "wv", "w_if", "down_proj")
_MLSTM_VECTOR = ("b_if", "norm_g")
_SLSTM_LINEAR = ("w_in", "out_proj")
_SLSTM_ARRAY = ("r", "b", "norm_g")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_attention(attn_module, arrays, i) -> None:
    for n in _ATTN:
        getattr(attn_module, n).weight.copy_(arrays[n][i].t())
    if attn_module.q_norm is not None:
        for n in _QK_NORM:
            getattr(attn_module, n).copy_(arrays[n][i])


def _load_linears(module, arrays, names, i) -> None:
    for n in names:
        getattr(module, n).weight.copy_(arrays[n][i].t())


def _load_mlp(mlp, arrays, i) -> None:
    """A SwiGLU's three matrices, or a GELU MLP's two and their biases."""
    if "b_in" not in arrays:
        _load_linears(mlp, arrays, _MLP, i)
        return
    _load_linears(mlp, arrays, _GELU, i)
    mlp.w_in.bias.copy_(arrays["b_in"][i])
    mlp.w_out.bias.copy_(arrays["b_out"][i])


def _arrays(tree) -> Dict[str, torch.Tensor]:
    return {n: _tensor(a) for n, a in tree.items() if not isinstance(a, dict)}


def _load_dense(blocks, stage) -> None:
    """``dense`` blocks, and the encoder's ``enc`` blocks (a GELU MLP)."""
    ln1, ln2 = _tensor(stage["ln1"]), _tensor(stage["ln2"])
    attn, mlp = _arrays(stage["attn"]), _arrays(stage["mlp"])
    for i, block in enumerate(blocks):
        block.ln1.copy_(ln1[i])
        block.ln2.copy_(ln2[i])
        _load_attention(block.attn, attn, i)
        _load_mlp(block.mlp, mlp, i)


def _load_moe(blocks, stage) -> None:
    ln1, ln2 = _tensor(stage["ln1"]), _tensor(stage["ln2"])
    attn, moe = _arrays(stage["attn"]), _arrays(stage["moe"])
    shared = _arrays(stage["moe"]["shared"]) if "shared" in stage["moe"] else None
    if (shared is None) != (blocks[0].moe.shared is None):
        raise ValueError("stages[0]'s shared experts do not match the config's "
                         "n_shared_experts")
    for i, block in enumerate(blocks):
        block.ln1.copy_(ln1[i])
        block.ln2.copy_(ln2[i])
        _load_attention(block.attn, attn, i)
        for n in _EXPERTS:
            getattr(block.moe, n).copy_(moe[n][i])
        if shared is not None:
            _load_linears(block.moe.shared, shared, _MLP, i)
            block.moe.shared_gate.copy_(moe["shared_gate"][i])


def _load_dec(blocks, stage) -> None:
    lns = {n: _tensor(stage[n]) for n in ("ln1", "ln2", "ln3")}
    self_attn, cross = _arrays(stage["self_attn"]), _arrays(stage["cross_attn"])
    mlp = _arrays(stage["mlp"])
    for i, block in enumerate(blocks):
        for n, ln in lns.items():
            getattr(block, n).copy_(ln[i])
        _load_attention(block.self_attn, self_attn, i)
        _load_attention(block.cross_attn, cross, i)
        _load_mlp(block.mlp, mlp, i)


def _one_layer_stack(tree):
    """One block's parameter tree with a layer axis of 1 in front of every
    array, as a stage stacks them."""
    if isinstance(tree, dict):
        return {k: _one_layer_stack(v) for k, v in tree.items()}
    return np.asarray(tree)[None]


def _load_zamba(blocks, stage) -> None:
    mamba = stage["mamba"]
    ln = _tensor(mamba["ln"])
    lin = {n: _tensor(mamba["mixer"][n]) for n in _MAMBA_LINEAR}
    arr = {n: _tensor(mamba["mixer"][n]) for n in _MAMBA_ARRAY}
    per_super = len(blocks[0].mamba)
    if ln.shape[1] != per_super:
        raise ValueError(
            f"stages[0] holds {ln.shape[1]} Mamba-2 layers a super-block, the config "
            f"{per_super}"
        )
    for i, block in enumerate(blocks):
        for m, layer in enumerate(block.mamba):
            layer.ln.copy_(ln[i, m])
            for n in _MAMBA_LINEAR:
                getattr(layer.mixer, n).weight.copy_(lin[n][i, m].t())
            for n in _MAMBA_ARRAY:
                getattr(layer.mixer, n).copy_(arr[n][i, m])


def _load_xlstm(blocks, stage) -> None:
    m, s = stage["mlstm"], stage["slstm"]
    m_ln, s_ln = _tensor(m["ln"]), _tensor(s["ln"])
    mlin = {n: _tensor(m["mixer"][n]) for n in _MLSTM_LINEAR}
    mvec = {n: _tensor(m["mixer"][n]) for n in _MLSTM_VECTOR}
    slin = {n: _tensor(s["mixer"][n]) for n in _SLSTM_LINEAR}
    sarr = {n: _tensor(s["mixer"][n]) for n in _SLSTM_ARRAY}
    for i, block in enumerate(blocks):
        block.mlstm_ln.copy_(m_ln[i])
        block.slstm_ln.copy_(s_ln[i])
        for n in _MLSTM_LINEAR:
            getattr(block.mlstm, n).weight.copy_(mlin[n][i].t())
        for n in _MLSTM_VECTOR:
            getattr(block.mlstm, n).copy_(mvec[n][i])
        for n in _SLSTM_LINEAR:
            getattr(block.slstm, n).weight.copy_(slin[n][i].t())
        for n in _SLSTM_ARRAY:
            getattr(block.slstm, n).copy_(sarr[n][i])


_LOADERS = {"dense": (_load_dense, ("ln1",)), "moe": (_load_moe, ("ln1",)),
            "zamba_super": (_load_zamba, ("mamba", "ln")),
            "xlstm_pair": (_load_xlstm, ("mlstm", "ln")), "dec": (_load_dec, ("ln1",))}


def _check_layers(stage, path, n_blocks: int, what: str) -> None:
    first = stage
    for key in path:
        first = first[key]
    if np.shape(first)[0] != n_blocks:
        raise ValueError(f"{what} holds {np.shape(first)[0]} layers, the config {n_blocks}")


def params_from_arrays(cfg: ArchConfig, tree: Dict[str, Any], device: DeviceLike = None,
                       attn_impl: str = "auto", gla_impl: str = "auto") -> Transformer:
    """A :class:`Transformer` on ``device`` holding the reference's
    parameters ``tree``: the stacked layer axis is sliced into the blocks
    (a stage whose count differs from the config's raises ``ValueError``),
    and matrices are transposed into ``nn.Linear`` weights."""
    model = build_model(cfg, device, attn_impl, gla_impl)
    stage = tree["stages"][0]
    load, path = _LOADERS[model.block_type]
    _check_layers(stage, path, len(model.blocks), "stages[0]")
    if model.encoder is not None:
        _check_layers(tree["encoder"]["stage"], ("ln1",), len(model.encoder.blocks),
                      "encoder.stage")
    with torch.no_grad():
        model.embed.weight.copy_(_tensor(tree["embed"]))
        model.final_norm.copy_(_tensor(tree["final_norm"]))
        model.lm_head.weight.copy_(_tensor(tree["lm_head"]).t())
        load(model.blocks, stage)
        if model.shared_attn is not None:
            _load_dense([model.shared_attn], _one_layer_stack(tree["shared_attn"]))
        if model.encoder is not None:
            _load_dense(model.encoder.blocks, tree["encoder"]["stage"])
            model.encoder.final_norm.copy_(_tensor(tree["encoder"]["final_norm"]))
    return model
