"""The assigned LM input-shape sets and the dry run's input builders — the
reference's ``launch/shapes.py``, whose ``ShapeDtypeStruct`` builders
become builders of fake tensors.

  train_4k     seq 4096,    global_batch 256   -> train_step
  prefill_32k  seq 32768,   global_batch 32    -> prefill_step
  decode_32k   seq 32768,   global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288,  global_batch 1     -> serve_step; sub-quadratic
                                                  archs only

A fake tensor (``torch._subclasses.fake_tensor``) has a shape, a dtype and
a device but no memory: ops on it compute only their results' metadata.
The builders run inside :func:`fake_mode` (they raise elsewhere, so that
no caller allocates a 32k x 128 batch by mistake) and the dry run
(``launch/dryrun.py``) runs the model's real step functions on what they
return.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import Cache, Transformer, build_model


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPE_SETS: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "skip: pure full-attention arch at 524k context "
            "(quadratic prefill / O(ctx) KV decode; see DESIGN.md §Arch-applicability)"
        )
    return True, ""


def fake_mode() -> FakeTensorMode:
    """A mode whose factory ops make fake CPU tensors; real tensors that
    meet them (a module's constants) are taken as fake."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _require_fake(what: str) -> None:
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError(f"{what} builds fake tensors: call it inside shapes.fake_mode()")


def sds(shape, dtype) -> torch.Tensor:
    """A fake CPU tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    _require_fake("sds")
    return torch.empty(shape, dtype=dtype, device="cpu")


def fake_model(cfg: ArchConfig, **impls) -> Transformer:
    """``cfg``'s model with fake CPU parameters: built on the meta device
    outside the mode, then given fake storage (inside it, ``build_model``
    cannot swap a module's parameters for fake ones). ``impls`` are
    ``build_model``'s ``attn_impl`` and ``gla_impl``."""
    _require_fake("fake_model")
    with unset_fake_temporarily():
        model = build_model(cfg, "meta", **impls)
    return model.to_empty(device="cpu")


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The model-input batch (train/prefill): ``tokens`` ``[B, S]`` int64
    and the arch's ``image_embeds`` or ``encoder_frames``."""
    b, s = shape.batch, shape.seq
    batch = {"tokens": sds((b, s), torch.int64)}
    if cfg.n_image_embeds:
        batch["image_embeds"] = sds((b, cfg.n_image_embeds, cfg.d_model), cfg.dtype)
    if cfg.encoder_layers:
        batch["encoder_frames"] = sds((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return batch


def decode_specs(cfg: ArchConfig, model: Transformer, shape: ShapeSpec
                 ) -> Tuple[torch.Tensor, Cache, int]:
    """(tokens ``[B, 1]``, ``model.init_cache(B, S)``, pos) for
    ``decode_step``. The reference's pos is a traced scalar, so its step
    reads the whole cache; here pos is ``S - 1``, the last slot, whose step
    reads all ``S`` keys too."""
    _require_fake("decode_specs")
    b, s = shape.batch, shape.seq
    return sds((b, 1), torch.int64), model.init_cache(b, s), s - 1


def train_accum_steps(cfg: ArchConfig, n_params: int, shape: ShapeSpec) -> int:
    """Microbatch accumulation for the train shape (keeps activations in HBM)."""
    if n_params > 1e10:
        return 8
    if n_params > 3e9:
        return 4
    return 1


def param_count(cfg: ArchConfig) -> int:
    """The parameters of ``cfg``'s model, counted on the meta device."""
    return build_model(cfg, "meta").n_params()
