"""Carry the reference's LM parameters into the port.

The reference keeps parameters as a pytree of arrays: ``embed`` ``[Vp, D]``,
``final_norm`` ``[D]``, ``lm_head`` ``[D, Vp]`` and ``stages[0]``, the
stage's per-layer parameters stacked on a leading axis; matrices are
``[in, out]``. A ``dense`` stage holds ``ln1``, ``attn.{wq,wk,wv,wo}``,
``ln2`` and ``mlp.{w_gate,w_up,w_down}``; an ``xlstm_pair`` stage holds
``mlstm.{ln, mixer.{up_proj, wq, wk, wv, w_if, b_if, norm_g, down_proj}}``
and ``slstm.{ln, mixer.{w_in, r, b, norm_g, out_proj}}``. Here that tree
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
_MLP = ("w_gate", "w_up", "w_down")
_MLSTM_LINEAR = ("up_proj", "wq", "wk", "wv", "w_if", "down_proj")
_MLSTM_VECTOR = ("b_if", "norm_g")
_SLSTM_LINEAR = ("w_in", "out_proj")
_SLSTM_ARRAY = ("r", "b", "norm_g")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_dense(blocks, stage) -> None:
    ln1, ln2 = _tensor(stage["ln1"]), _tensor(stage["ln2"])
    attn = {n: _tensor(stage["attn"][n]) for n in _ATTN}
    mlp = {n: _tensor(stage["mlp"][n]) for n in _MLP}
    for i, block in enumerate(blocks):
        block.ln1.copy_(ln1[i])
        block.ln2.copy_(ln2[i])
        for n in _ATTN:
            getattr(block.attn, n).weight.copy_(attn[n][i].t())
        for n in _MLP:
            getattr(block.mlp, n).weight.copy_(mlp[n][i].t())


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


_LOADERS = {"dense": (_load_dense, ("ln1",)), "xlstm_pair": (_load_xlstm, ("mlstm", "ln"))}


def params_from_arrays(cfg: ArchConfig, tree: Dict[str, Any], device: DeviceLike = None,
                       attn_impl: str = "auto", gla_impl: str = "auto") -> Transformer:
    """A :class:`Transformer` on ``device`` holding the reference's
    parameters ``tree``: the stacked layer axis is sliced into the blocks,
    and matrices are transposed into ``nn.Linear`` weights."""
    model = build_model(cfg, device, attn_impl, gla_impl)
    stage = tree["stages"][0]
    load, path = _LOADERS[model.block_type]
    first = stage
    for key in path:
        first = first[key]
    n_blocks = len(model.blocks)
    if np.shape(first)[0] != n_blocks:
        raise ValueError(
            f"stages[0] holds {np.shape(first)[0]} layers, the config {n_blocks}"
        )
    with torch.no_grad():
        model.embed.weight.copy_(_tensor(tree["embed"]))
        model.final_norm.copy_(_tensor(tree["final_norm"]))
        model.lm_head.weight.copy_(_tensor(tree["lm_head"]).t())
        load(model.blocks, stage)
    return model
