"""Chunked GLA scan: the kernel wrapper and its plain versions.

:func:`ssd_scan` evaluates the gated-linear-attention recurrence

    h_t = exp(g_t) · h_{t-1} + k_t ⊗ v_t,    y_t = q_t · h_t

for q, k ``[B, S, H, dk]``, v ``[B, S, H, dv]`` and log decays g ``[B, S,
H]`` (g ≤ 0), from ``h0`` ``[B, H, dk, dv]`` f32 (zeros when None), and
returns ``(y [B, S, H, dv] in v's dtype, h_final [B, H, dk, dv] f32)``.
Every operand is cast to f32 on its own and every product is f32, as in the
reference.

It replaces the TPU kernel ``_ssd_kernel`` of ``repro/kernels/ssd_scan.py``
(and its wrapper in ``kernels/ops.py``); the function is ``chunked_gla`` of
``repro/models/ssm.py``. On a CUDA tensor the wrapper launches the
hand-written kernels in ``csrc/ssd_scan.cu`` or raises; on a CPU tensor it
runs :func:`ssd_scan_plain`, the port of ``chunked_gla`` (which falls back
to the sequential :func:`gla_scan_plain`, the port of ``gla_reference``,
when ``chunk`` does not divide S). The reference wrapper's fallback to its
oracle for a ragged S is not carried over: the kernels mask the last chunk
(its missing steps read g = 0 and q = k = v = 0, which leaves y and the
state unchanged), so any S runs on the card.

The work is bound by f32 operations (72 us at the xLSTM serve prefill's dv
512 on an H100), so the CUDA route computes each product once and spreads
it over the card: one wrapper call is :data:`KERNELS_PER_CALL` launches —
a chunk pass (each chunk's causal scores and state contribution, every
(chunk, head, batch) in parallel), a state pass (sequential over the chunks
only, a thread per 4 state elements) and an output pass (scores · v plus the
decayed q · h_in, in parallel again). :func:`launch_plan` gives their grids
and the f32 scratch the wrapper allocates. ``LAUNCHES["ssd_scan"]`` counts
wrapper calls that launched them.

The kernels compute the forward only: on CUDA inputs that autograd would
record, the wrapper raises (``_build.refuse_grad``). Training takes
the plain scan (``gla_impl="plain"``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

NAME = "ssd_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
MAX_CHUNK = 128  # the chunk pass's cumsum takes 4 steps a lane of one warp
KERNELS_PER_CALL = 3  # chunk pass, state pass, output pass
THREADS = 256  # per block, in every pass
TILE_M = 64  # rows of every tile product
SCORE_DEPTH = 128  # dk per score block: a chunk's scores are summed over dk slices
NARROW_DV = 4  # dv up to this takes the output pass with a warp per step
MAX_GRID_YZ = 65535

# wrapper calls that launched the kernels (the plain route never counts)
LAUNCHES: Dict[str, int] = {NAME: 0}

_LAUNCH_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    LAUNCHES[NAME] = 0


def _launch_fn():
    """The ctypes entry point ``ssd_scan_launch``, with its C signature."""
    fn = _LAUNCH_FNS.get(NAME)
    if fn is None:
        fn = _build.load(NAME).ssd_scan_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _LAUNCH_FNS[NAME] = fn
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(b: int, s: int, h: int, dk: int, dv: int, chunk: int) -> Dict[str, object]:
    """The CUDA route's launches at these sizes (what ``ssd_scan_plan`` in
    ``csrc/ssd_scan.cu`` computes): ``grids``, the (x, y, z) grid of the
    chunk, state and output passes, each of ``THREADS`` threads;
    ``tile_n``, the width of the state (and wide output) tiles, 128 when dv
    > 64, else 64; ``score_parts``, the dk slices of ``SCORE_DEPTH`` each
    chunk's scores are summed over; ``score_blocks``, the chunk pass's
    score blocks per chunk (lower-triangle 64 x 64 tiles times slices);
    ``narrow``, whether the output pass takes a warp per step (dv <=
    ``NARROW_DV``) instead of 64 x ``tile_n`` tiles; and ``scratch``, the
    shapes of the f32 scratch: the partial scores ``[B, H, n, parts, C,
    C]``, the states ``[B, H, n, dk, dv]`` (each chunk's contribution, then
    the state entering it) and the cumsums ``[B, H, n, C]``."""
    n = _cdiv(s, chunk)
    nt = _cdiv(chunk, TILE_M)
    bn = 128 if dv > 64 else 64
    parts = _cdiv(dk, SCORE_DEPTH)
    score_blocks = nt * (nt + 1) // 2 * parts
    narrow = dv <= NARROW_DV
    out_x = _cdiv(chunk, THREADS // 32) if narrow else nt * _cdiv(dv, bn)
    return {
        "grids": (
            (score_blocks + _cdiv(dk, TILE_M) * _cdiv(dv, bn), n, b * h),
            (_cdiv(dk * dv, 4 * THREADS), b * h, 1),
            (out_x, n, b * h),
        ),
        "tile_n": bn,
        "score_parts": parts,
        "score_blocks": score_blocks,
        "narrow": narrow,
        "scratch": {
            "scores": (b, h, n, parts, chunk, chunk),
            "states": (b, h, n, dk, dv),
            "bcum": (b, h, n, chunk),
        },
    }


def kernel_plan(b: int, s: int, h: int, dk: int, dv: int, chunk: int) -> Dict[str, object]:
    """The grids, tile width and score slices that ``ssd_scan_plan`` of the
    built library computes, in :func:`launch_plan`'s keys (needs the CUDA
    toolkit)."""
    fn = _build.load(NAME).ssd_scan_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 11)()
    err = fn(b, s, h, dk, dv, chunk, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"{NAME}: the kernels do not take {(b, s, h, dk, dv, chunk)}")
    return {"grids": (tuple(out[0:3]), tuple(out[3:6]), tuple(out[6:9])),
            "tile_n": out[9], "score_parts": out[10]}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gla_scan_plain(q, k, v, g, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one step at a time (``gla_scan_reference``)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    hst = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
           if h0 is None else h0)
    g = g.float()
    ys = []
    for t in range(s):
        hst = torch.exp(g[:, t])[..., None, None] * hst + torch.einsum(
            "bhk,bhv->bhkv", k[:, t].float(), v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t].float(), hst))
    y = torch.stack(ys, 1) if ys else torch.zeros(v.shape, device=v.device)
    return y.to(v.dtype), hst


def ssd_scan_plain(q, k, v, g, h0=None, chunk: int = 128):
    """The reference's ``chunked_gla`` in plain PyTorch: masked,
    decay-weighted (Q·Kᵀ)·V inside each chunk and a sequential pass over the
    chunks' states; the sequential scan when ``chunk`` does not divide S."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk != 0:
        return gla_scan_plain(q, k, v, g, h0)
    n = s // chunk
    if h0 is None:
        h0 = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    qc = q.reshape(b, n, chunk, h, dk).float()
    kc = k.reshape(b, n, chunk, h, dk).float()
    vc = v.reshape(b, n, chunk, h, dv).float()
    bcum = torch.cumsum(g.float().reshape(b, n, chunk, h), dim=2)

    # intra-chunk: y_intra[t] = sum_{s<=t} exp(b_t - b_s) (q_t.k_s) v_s
    diff = bcum[:, :, :, None, :] - bcum[:, :, None, :, :]  # [B,n,T,S,H]
    idx = torch.arange(chunk, device=q.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.where(mask, torch.exp(diff), torch.zeros((), device=q.device))
    scores = torch.einsum("bnthk,bnshk->bntsh", qc, kc)
    y_intra = torch.einsum("bntsh,bnshv->bnthv", scores * decay, vc)

    # per-chunk state contribution sum_s exp(b_L - b_s) k_s v_s, and decay
    b_end = bcum[:, :, -1:, :]
    k_scaled = kc * torch.exp(b_end - bcum)[..., None]
    chunk_state = torch.einsum("bnshk,bnshv->bnhkv", k_scaled, vc)
    chunk_decay = torch.exp(b_end[:, :, 0, :])  # [B,n,H]

    # inter-chunk pass: h_c = decay_c * h_{c-1} + state_c
    hst, starts = h0, []
    for c in range(n):
        starts.append(hst)
        hst = chunk_decay[:, c, :, None, None] * hst + chunk_state[:, c]
    h_starts = torch.stack(starts, 1)  # [B,n,H,dk,dv] state entering each chunk

    q_scaled = qc * torch.exp(bcum)[..., None]
    y_inter = torch.einsum("bnthk,bnhkv->bnthv", q_scaled, h_starts)
    y = (y_intra + y_inter).reshape(b, s, h, dv)
    return y.to(v.dtype), hst


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, g, h0, chunk: int) -> None:
    """Ranks, shapes, dtypes, strides and devices the kernel takes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or g.dim() != 3:
        raise ValueError(f"{NAME}: q, k, v must be 4-d [B, S, H, d] and g 3-d [B, S, H]")
    b, s, h, dk = q.shape
    dv = v.shape[3]
    if k.shape != q.shape or v.shape[:3] != (b, s, h) or g.shape != (b, s, h):
        raise ValueError(
            f"{NAME}: q, k must be [B, S, H, dk], v [B, S, H, dv] and g [B, S, H], got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, g {tuple(g.shape)}"
        )
    for key, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES:
            raise TypeError(f"{NAME}: {key} must be one of {list(DTYPES)}, got {x.dtype}")
    if g.dtype != torch.float32:
        raise TypeError(f"{NAME}: g must be float32, got {g.dtype}")
    if h0 is not None:
        if h0.shape != (b, h, dk, dv) or h0.dtype != torch.float32:
            raise ValueError(
                f"{NAME}: h0 must be float32 [B, H, dk, dv] = {(b, h, dk, dv)}, got "
                f"{h0.dtype} {tuple(h0.shape)}"
            )
    if chunk < 1:
        raise ValueError(f"{NAME}: chunk must be positive, got {chunk}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME} runs on cuda or cpu, not {dev}")
    if any(x.device != dev for x in (k, v, g)) or (h0 is not None and h0.device != dev):
        raise ValueError(f"{NAME}: q, k, v, g and h0 must be on one device")
    if dev.type == "cuda":
        _build.refuse_grad(NAME, q, k, v, g, h0)
        for key, x in (("q", q), ("k", k), ("v", v)):
            if x.stride(3) != 1:
                raise ValueError(f"{NAME}: {key}'s last dimension must be contiguous")
        if h0 is not None and not h0.is_contiguous():
            raise ValueError(f"{NAME}: h0 must be contiguous")
        if chunk % 8 or chunk > MAX_CHUNK:
            raise ValueError(
                f"{NAME}: chunk must be a multiple of 8 up to {MAX_CHUNK}, got {chunk}")
        if b * h > MAX_GRID_YZ or _cdiv(s, chunk) > MAX_GRID_YZ:
            raise ValueError(
                f"{NAME}: B * H and the number of chunks must be at most {MAX_GRID_YZ} "
                "(the grids' y and z)")


def ssd_scan(
    q: torch.Tensor,  # [B, S, H, dk]
    k: torch.Tensor,  # [B, S, H, dk]
    v: torch.Tensor,  # [B, S, H, dv]
    g: torch.Tensor,  # [B, S, H] f32 log decay (<= 0)
    h0: Optional[torch.Tensor] = None,  # [B, H, dk, dv] f32
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked GLA scan: ``(y [B, S, H, dv] in v's dtype, h_final [B,
    H, dk, dv] f32)``.

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take :func:`ssd_scan_plain`. Zero-size inputs short-circuit: an
    empty sequence returns an empty y and leaves the state at ``h0``.
    """
    _check(q, k, v, g, h0, chunk)
    b, s, h, dk = q.shape
    dv = v.shape[3]
    if q.numel() == 0 or v.numel() == 0:
        h_final = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
                   if h0 is None else h0.clone())
        return torch.zeros(v.shape, dtype=v.dtype, device=v.device), h_final
    if q.device.type == "cpu":
        return ssd_scan_plain(q, k, v, g, h0, chunk)
    y = torch.empty((b, s, h, dv), dtype=v.dtype, device=v.device)
    h_final = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    scratch = [torch.empty(shape, dtype=torch.float32, device=q.device)
               for shape in launch_plan(b, s, h, dk, dv, chunk)["scratch"].values()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            *(x.data_ptr() for x in scratch),
            b, s, h, dk, dv, chunk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride(),
            DTYPES[q.dtype], DTYPES[k.dtype], DTYPES[v.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{NAME} kernels failed to launch (cudaError {err})")
    LAUNCHES[NAME] += 1
    return y, h_final
