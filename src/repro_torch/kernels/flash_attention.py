"""Flash attention forward: the kernel wrapper and its plain version.

:func:`flash_attention` computes causal (or full) GQA attention for q
``[B, Sq, H, hd]`` and k, v ``[B, Sk, KH, hd]``, query head ``h`` reading KV
head ``h // (H // KH)``; the causal mask is top-left (``qpos >= kpos``, both
counted from 0), so any ``Sq`` and ``Sk`` are taken. Softmax statistics and
the accumulator are f32, masked logits are -1e30, the output is ``acc /
max(l, 1e-30)`` in q's dtype, and ``sm_scale`` defaults to ``1/sqrt(hd)``.

It replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (and its wrapper in ``kernels/ops.py``).
On a CUDA tensor the wrapper launches one of the two hand-written kernels in
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, the port of ``ref.flash_attention_reference``
(materialised scores, f32 softmax). The reference wrapper's fallback to its
oracle for a ragged ``Sq`` is not carried over: both kernels mask any ``Sq``.

Which kernel serves a call is a static table, :data:`VARIANTS`, keyed on
(dtype, head dim), never a reaction to a failure:

- ``"wgmma"`` (``flash_attention_wgmma_kernel``): bf16 at hd 64, 80 and
  128, every serve path's prefill among them (hd 80: stablelm-3b and
  zamba2-2.7b's shared attention). The work is bound by bf16 tensor-core
  operations (4.35 us at the internlm2-1.8b prefill shape on an H100), so
  Q·Kᵀ and P·V run as ``wgmma`` on tiles that ``cp.async`` streams into
  swizzled shared memory (the 128-byte swizzle at hd 64 and 128, the
  32-byte one at hd 80), with the online softmax in registers.
- ``"simt"`` (``flash_attention_kernel``): everything else — f32 at every
  head dim (TF32 tensor cores would not hold f32's 2e-5) and bf16 at the
  other head dims — in f32 FMAs on the CUDA cores.

The kernels compute the forward only, and the reference defines no VJP:
on CUDA tensors that autograd would record (grad mode on, an input that
requires grad) the wrapper raises rather than return an output without a
gradient. Training takes the plain attention (``attn_impl="naive"``).

``LAUNCHES["flash_attention"]`` counts every kernel launch, and
``LAUNCHES["flash_attention_<variant>"]`` the launches of each variant.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the SIMT kernel's dtype codes
HEAD_DIMS = range(16, 257, 16)

# (dtype, head dim) -> kernel variant; every other pair takes "simt"
VARIANTS: Dict[Tuple[torch.dtype, int], str] = {
    (torch.bfloat16, 64): "wgmma",
    (torch.bfloat16, 80): "wgmma",
    (torch.bfloat16, 128): "wgmma",
}

# kernel launches made by the wrapper: all of them, and each variant's (the
# plain route never counts)
LAUNCHES: Dict[str, int] = {NAME: 0, f"{NAME}_wgmma": 0, f"{NAME}_simt": 0}

_LAUNCH_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves ``(dtype, hd)`` on the card: "wgmma" or "simt"."""
    return VARIANTS.get((dtype, hd), "simt")


def _launch_fn(route: str):
    """The ctypes entry point of ``route`` (``flash_attention_launch`` or
    ``flash_attention_wgmma_launch``), with its C signature."""
    fn = _LAUNCH_FNS.get(route)
    if fn is None:
        lib = _build.load(NAME)
        if route == "wgmma":
            fn = lib.flash_attention_wgmma_launch
            tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = lib.flash_attention_launch
            tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + tail
        fn.restype = ctypes.c_int
        _LAUNCH_FNS[route] = fn
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
        _build.refuse_grad(NAME, q, k, v)
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

    CUDA tensors launch the kernel that :func:`variant` names (and raise if
    it cannot launch); CPU tensors take :func:`flash_attention_plain`.
    Zero-size inputs short-circuit to zeros.
    """
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    return launch_variant(variant(q.dtype, hd), q, k, v, causal=causal, sm_scale=sm_scale)


# spars-lint: ignore[PL004] the entry to a named variant, for benchmarks:
# flash_attention checks, short-circuits, routes the CPU and refuses grad
# before it calls this
def launch_variant(
    route: str,
    q: torch.Tensor,  # [B, Sq, H, hd], on the card
    k: torch.Tensor,  # [B, Sk, KH, hd]
    v: torch.Tensor,  # [B, Sk, KH, hd]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel variant ``route`` on non-empty CUDA tensors that
    :func:`flash_attention` has checked, and count it. The wrapper names the
    variant from :data:`VARIANTS`; a benchmark may name "simt" for bf16 to
    time both kernels on the same inputs. Raises if the kernel does not
    take the call or fails to launch."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if route == "wgmma" and (q.dtype, hd) not in VARIANTS:
        raise ValueError(f"{NAME}: the wgmma kernel takes bf16 at hd 64, 80 and 128, not "
                         f"{q.dtype} at hd {hd}")
    scale = 1.0 / math.sqrt(hd) if sm_scale is None else float(sm_scale)
    if route == "wgmma":  # 16-byte cp.async reads: a view at an odd offset is copied
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kh, hd, scale, int(causal)]
    if route == "simt":
        args.append(DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = _launch_fn(route)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} {route} kernel failed to launch (cudaError {err})")
    LAUNCHES[NAME] += 1
    LAUNCHES[f"{NAME}_{route}"] += 1
    return out
