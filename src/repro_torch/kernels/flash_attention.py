"""Flash attention forward: the kernel wrapper and its plain version.

:func:`flash_attention` computes causal (or full) GQA attention for q
``[B, Sq, H, hd]`` and k, v ``[B, Sk, KH, hd]``, query head ``h`` reading KV
head ``h // (H // KH)``; the causal mask is top-left (``qpos >= kpos``, both
counted from 0), so any ``Sq`` and ``Sk`` are taken. Softmax statistics and
the accumulator are f32, masked logits are -1e30, the output is ``acc /
max(l, 1e-30)`` in q's dtype, and ``sm_scale`` defaults to ``1/sqrt(hd)``.

It replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (and its wrapper in ``kernels/ops.py``).
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, the port of ``ref.flash_attention_reference``
(materialised scores, f32 softmax). The reference wrapper's fallback to its
oracle for a ragged ``Sq`` is not carried over: the kernel masks any ``Sq``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes
HEAD_DIMS = range(16, 257, 16)

# kernel launches made by the wrapper (the plain route never counts)
LAUNCHES: Dict[str, int] = {NAME: 0}

_LAUNCH_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    LAUNCHES[NAME] = 0


def _launch_fn():
    """The ctypes entry point ``flash_attention_launch``, with its C signature."""
    fn = _LAUNCH_FNS.get(NAME)
    if fn is None:
        fn = _build.load(NAME).flash_attention_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _LAUNCH_FNS[NAME] = fn
    return fn


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KH, hd]
    v: torch.Tensor,  # [B, Sk, KH, hd]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: materialised scores, f32 softmax."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    n_rep = h // kh
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        pos = torch.arange(max(sq, sk), device=q.device)
        mask = pos[:sq, None] >= pos[None, :sk]
        s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def _check(q, k, v) -> None:
    """Ranks, shapes, dtypes, head dim and devices the kernel takes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{NAME}: q, k, v must be 4-d [B, S, heads, hd]")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(
            f"{NAME}: k and v must be [B, Sk, KH, hd] with q's B and hd, got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    kh = k.shape[2]
    if kh and h % kh:
        raise ValueError(f"{NAME}: query heads {h} are not a multiple of KV heads {kh}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{NAME}: q, k, v must share one dtype of {list(DTYPES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim must be 16..256 in steps of 16, got {hd}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME} runs on cuda or cpu, not {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{NAME}: q, k, v must be on one device")
    if dev.type == "cuda":
        for key, x in (("q", q), ("k", k), ("v", v)):
            if not x.is_contiguous():
                raise ValueError(f"{NAME}: {key} must be contiguous")
        if b > 65535 or h > 65535:
            raise ValueError(f"{NAME}: B and H must be at most 65535 (the grid's y, z)")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KH, hd]
    v: torch.Tensor,  # [B, Sk, KH, hd]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward, ``[B, Sq, H, hd]`` in q's dtype.

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take :func:`flash_attention_plain`. Zero-size inputs
    short-circuit to zeros.
    """
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kh, hd, scale, int(causal), DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{NAME} kernel failed to launch (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
