"""Carry the reference's LM parameters into the port.

The reference keeps parameters as a pytree of arrays: ``embed`` ``[Vp, D]``,
``final_norm`` ``[D]``, ``lm_head`` ``[D, Vp]`` and ``stages[0]``, the dense
stage's per-layer parameters stacked on a leading ``[L]`` axis (``ln1``,
``attn.{wq,wk,wv,wo}``, ``ln2``, ``mlp.{w_gate,w_up,w_down}``; matrices
``[in, out]``). Here that tree comes as nested dicts and tuples of numpy
arrays (or anything ``numpy.asarray`` reads, bf16 included), and goes
through f32, which holds bf16 and f32 values exactly.
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


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_arrays(cfg: ArchConfig, tree: Dict[str, Any],
                       device: DeviceLike = None, attn_impl: str = "auto") -> Transformer:
    """A :class:`Transformer` on ``device`` holding the reference's
    parameters ``tree``: the stacked layer axis is sliced into the blocks,
    and matrices are transposed into ``nn.Linear`` weights."""
    model = build_model(cfg, device, attn_impl)
    stage = tree["stages"][0]
    n_layers = len(model.blocks)
    if np.shape(stage["ln1"])[0] != n_layers:
        raise ValueError(
            f"stages[0] holds {np.shape(stage['ln1'])[0]} layers, the config {n_layers}"
        )
    with torch.no_grad():
        model.embed.weight.copy_(_tensor(tree["embed"]))
        model.final_norm.copy_(_tensor(tree["final_norm"]))
        model.lm_head.weight.copy_(_tensor(tree["lm_head"]).t())
        ln1, ln2 = _tensor(stage["ln1"]), _tensor(stage["ln2"])
        attn = {n: _tensor(stage["attn"][n]) for n in _ATTN}
        mlp = {n: _tensor(stage["mlp"][n]) for n in _MLP}
        for i, block in enumerate(model.blocks):
            block.ln1.copy_(ln1[i])
            block.ln2.copy_(ln2[i])
            for n in _ATTN:
                getattr(block.attn, n).weight.copy_(attn[n][i].t())
            for n in _MLP:
                getattr(block.mlp, n).weight.copy_(mlp[n][i].t())
    return model
