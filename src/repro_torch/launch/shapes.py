"""The assigned LM input-shape sets — the shape specs of the reference's
``launch/shapes.py`` (its array builders are the JAX dry-run's and are not
ported).

  train_4k     seq 4096,    global_batch 256   -> train_step
  prefill_32k  seq 32768,   global_batch 32    -> prefill_step
  decode_32k   seq 32768,   global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288,  global_batch 1     -> serve_step; sub-quadratic
                                                  archs only
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig


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
