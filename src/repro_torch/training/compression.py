"""Gradient compression — the reference's ``training/compression.py`` over
lists of tensors: int8 quantization and top-k sparsification with error
feedback.

* ``int8`` — per-tensor symmetric quantization, applied as a
  quantize-dequantize round trip (the numerics of an int8 wire whose
  reduce runs on the dequantized values): one f32 scale ``max|g| / 127``
  (at least 1e-12), values rounded half to even and clipped to ±127.
* ``topk`` — keep the entries whose ``|g|`` reaches the k-th largest, ``k
  = max(1, int(size * fraction))``, zero the rest. Biased on its own, so
  pair it with error feedback (Karimireddy et al., 2019): what was not
  sent is added back to the next step's gradient.

Both pass a tensor of fewer than 1024 elements (or no dimensions) through.
In LM training the tensors are the reference's stacked leaves
(``models/convert.py`` ``reference_leaves``), so the int8 scale, ``k`` and
the 1024 test are taken over the leaf the reference takes them over.
``COMPRESSORS`` maps ``TrainStepConfig.compression``'s names to the
stateless transforms.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

F32 = torch.float32
Tensors = Sequence[torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x.to(F32))) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def _small(g: torch.Tensor) -> bool:
    return g.dim() < 1 or g.numel() < 1024  # tiny tensors: not worth it


def int8_compress(grads: Tensors) -> List[torch.Tensor]:
    """The quantize-dequantize round trip of every tensor."""
    out = []
    for g in grads:
        if _small(g):
            out.append(g)
            continue
        q, s = quantize_int8(g)
        out.append(dequantize_int8(q, s, g.dtype))
    return out


def topk_compress(grads: Tensors, fraction: float = 0.05) -> List[torch.Tensor]:
    """Keep the top-``fraction`` ``|g|`` entries of every tensor (ties at
    the threshold kept), the rest zeroed."""
    out = []
    for g in grads:
        if _small(g):
            out.append(g)
            continue
        k = max(1, int(g.numel() * fraction))
        mag = torch.abs(g.to(F32))
        thresh = torch.topk(mag.reshape(-1), k).values[-1]
        out.append(torch.where(mag >= thresh, g, torch.zeros_like(g)))
    return out


COMPRESSORS: Dict[str, Callable[[Tensors], List[torch.Tensor]]] = {
    "int8": int8_compress,
    "topk": topk_compress,
}


class ErrorFeedbackState(NamedTuple):
    residual: List[torch.Tensor]  # f32, one a gradient tensor


def error_feedback_init(params: Tensors) -> ErrorFeedbackState:
    return ErrorFeedbackState([torch.zeros(p.shape, dtype=F32, device=p.device)
                               for p in params])


def error_feedback_apply(
    state: ErrorFeedbackState,
    grads: Tensors,
    compressor: Callable[[Tensors], List[torch.Tensor]],
) -> Tuple[List[torch.Tensor], ErrorFeedbackState]:
    """``compressed(g + residual)``; ``residual' = (g + residual) -
    compressed``."""
    corrected = [g.to(F32) + r for g, r in zip(grads, state.residual)]
    sent = compressor(corrected)
    residual = [c - s.to(F32) for c, s in zip(corrected, sent)]
    return [s.to(g.dtype) for s, g in zip(sent, grads)], ErrorFeedbackState(residual)
