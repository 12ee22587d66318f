"""Core layers of the dense LM: init helpers, RMS norm, RoPE, GQA attention
with a KV cache, and the SwiGLU MLP.

The dense subset of the reference's ``models/layers.py``, with its cast
order kept exactly: ``rms_norm`` normalises in f32, casts to the input dtype,
then multiplies by the gain; RoPE runs in f32 and casts back; logits are
computed in the input dtype, cast to f32 and scaled; masked logits are -1e30.

Attention routes (``attn_impl``, the reference's values):

* ``"naive"`` — the plain masked attention (:func:`_masked_naive`),
  everywhere;
* ``"auto"`` (and ``"chunked"``, the reference's name for its XLA twin of
  the flash kernel) — attention that starts at position 0 (the cache-free
  forward, and prefill at ``cache_pos == 0``) goes to the flash attention
  kernel over the fresh k, v; decode keeps the plain masked attention over
  the cache, as the reference computes it outside any kernel.

Prefill at ``cache_pos == 0`` over the fresh k, v equals the reference's
masked attention over the whole cache: the causal mask, counted from 0,
already excludes every slot at or past the prompt length, which is all that
its ``kv_valid`` mask removes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

ATTN_IMPLS = ("auto", "naive", "chunked")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, fan_in: int, fan_out: int, dtype) -> torch.Tensor:
    """``[fan_in, fan_out]`` normal draws scaled by ``sqrt(1 / fan_in)``."""
    w = torch.randn((fan_in, fan_out), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * math.sqrt(1.0 / fan_in)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gain


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None, None].float() * freqs  # [..., S, 1, hd/2]
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,K,hd] -> [B,S,K*n_rep,hd] (GQA expansion)."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(b, s, kh * n_rep, hd)


def attention_naive(
    q: torch.Tensor,  # [B,Sq,H,hd]
    k: torch.Tensor,  # [B,Sk,K,hd]
    v: torch.Tensor,  # [B,Sk,K,hd]
    causal: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialised-scores attention (the oracle)."""
    h, kh = q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = _causal_mask(sq, sk, q_offset, q.device)
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _causal_mask(sq: int, sk: int, q_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device) + q_offset
    return qpos[:, None] >= torch.arange(sk, device=device)[None, :]


class RowOffsets(NamedTuple):
    """Each row's own cache offset for one step, built once and read by
    every layer: the scatter indices ``rows`` [B, 1] and ``cols`` [B, S] of
    the step's keys and values, and ``hidden`` [B, 1, S, Sk], the cached
    keys each query may not see (broadcast over heads)."""

    rows: torch.Tensor
    cols: torch.Tensor
    hidden: torch.Tensor


def row_offsets(cache_pos: torch.Tensor, s: int, sk: int) -> RowOffsets:
    """:class:`RowOffsets` of ``s`` queries at the ``[B]`` offsets
    ``cache_pos`` into a cache of ``sk`` positions: row b's query i sits at
    ``cache_pos[b] + i`` and sees keys ``[0, cache_pos[b] + i]``."""
    dev = cache_pos.device
    cols = cache_pos[:, None] + torch.arange(s, device=dev)
    hidden = (cols[:, :, None] < torch.arange(sk, device=dev))[:, None]
    return RowOffsets(torch.arange(cache_pos.shape[0], device=dev)[:, None], cols, hidden)


def _masked_naive(q, k, v, causal: bool, q_offset) -> torch.Tensor:
    """The reference's ``_masked_naive`` over the valid keys ``k, v``: each
    query head ``h`` scores KV head ``h // n_rep`` directly (grouped, so the
    repeat of the cache is never materialised). ``q_offset`` is the batch's
    one offset, or a :class:`RowOffsets` whose mask is each row's own."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    n_rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, n_rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).reshape(b, h, sq, sk)
    logits = logits.float() * scale
    if causal:
        hidden = (q_offset.hidden if isinstance(q_offset, RowOffsets)
                  else ~_causal_mask(sq, sk, q_offset, q.device))
        logits = logits.masked_fill(hidden, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.reshape(b, kh, n_rep, sq, sk), v)
    return out.reshape(b, sq, h, hd)


def _attend(q, k, v, causal: bool, q_offset, impl: str) -> torch.Tensor:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl != "naive" and not isinstance(q_offset, RowOffsets) and q_offset == 0:
        return flash_attention(q, k, v, causal=causal)
    return _masked_naive(q, k, v, causal, q_offset)


class Attention(nn.Module):
    """GQA self-attention with RoPE and a KV cache (the reference's
    ``qk_norm`` variant belongs to archs not ported yet).

    ``wq``/``wk``/``wv``/``wo`` are ``nn.Linear``s, so their weights are the
    reference's ``[in, out]`` matrices transposed.
    """

    def __init__(self, d_model, n_heads, n_kv_heads, head_dim, dtype, *, theta: float):
        super().__init__()
        self.n_heads, self.n_kv_heads, self.head_dim = n_heads, n_kv_heads, head_dim
        self.theta = theta
        self.wq = nn.Linear(d_model, n_heads * head_dim, bias=False, dtype=dtype)
        self.wk = nn.Linear(d_model, n_kv_heads * head_dim, bias=False, dtype=dtype)
        self.wv = nn.Linear(d_model, n_kv_heads * head_dim, bias=False, dtype=dtype)
        self.wo = nn.Linear(n_heads * head_dim, d_model, bias=False, dtype=dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``attn_init``: scaled normal projections."""
        for lin in (self.wq, self.wk, self.wv, self.wo):
            w = dense_init(generator, lin.in_features, lin.out_features, lin.weight.dtype)
            lin.weight.copy_(w.t())

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """The reference's ``attn_qkv``: projections and RoPE."""
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, self.n_heads, self.head_dim)
        k = self.wk(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        v = self.wv(x).reshape(b, s, self.n_kv_heads, self.head_dim)
        if self.theta:
            q = apply_rope(q, positions, self.theta)
            k = apply_rope(k, positions, self.theta)
        return q, k, v

    def forward(
        self,
        x: torch.Tensor,
        positions: torch.Tensor,
        *,
        causal: bool = True,
        cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_pos: Union[int, torch.Tensor, RowOffsets] = 0,
        attn_impl: str = "auto",
    ) -> torch.Tensor:
        """Self-attention, ``[B, S, D]``.

        ``cache``: (k_cache, v_cache) ``[B, S_max, KH, hd]``, written in place
        at ``cache_pos``. A Python int is the batch's one offset: attention
        then reads the valid prefix ``[:cache_pos + S]`` with the causal mask
        offset by ``cache_pos`` — the reference's ``kv_valid`` and causal
        masks. A ``[B]`` tensor gives each row its own offset (``positions``
        is then ``[B, S]``): row b's keys and values are written at
        ``cache_pos[b]`` by one scatter, and it attends over the whole cache
        with its own mask, keys ``[0, cache_pos[b] + i]`` for query i. A
        :class:`RowOffsets` is such a tensor's indices and mask, built once
        for all layers by :func:`row_offsets`.
        """
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions)
        if cache is None:
            out = _attend(q, k, v, causal, 0, attn_impl)
        elif torch.is_tensor(cache_pos) or isinstance(cache_pos, RowOffsets):
            kc, vc = cache
            if torch.is_tensor(cache_pos):
                cache_pos = row_offsets(cache_pos, s, kc.shape[1])
            kc.index_put_((cache_pos.rows, cache_pos.cols), k)
            vc.index_put_((cache_pos.rows, cache_pos.cols), v)
            out = _attend(q, kc, vc, True, cache_pos, attn_impl)
        else:
            kc, vc = cache
            cache_pos = int(cache_pos)
            kc[:, cache_pos:cache_pos + s] = k
            vc[:, cache_pos:cache_pos + s] = v
            if cache_pos == 0:  # prefill: the valid prefix is the fresh k, v
                keys, vals = k.to(kc.dtype), v.to(vc.dtype)
            else:
                keys, vals = kc[:, :cache_pos + s], vc[:, :cache_pos + s]
            out = _attend(q, keys, vals, True, cache_pos, attn_impl)
        return self.wo(out.reshape(b, s, self.n_heads * self.head_dim))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype):
        super().__init__()
        self.w_gate = nn.Linear(d_model, d_ff, bias=False, dtype=dtype)
        self.w_up = nn.Linear(d_model, d_ff, bias=False, dtype=dtype)
        self.w_down = nn.Linear(d_ff, d_model, bias=False, dtype=dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for lin in (self.w_gate, self.w_up, self.w_down):
            w = dense_init(generator, lin.in_features, lin.out_features, lin.weight.dtype)
            lin.weight.copy_(w.t())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))
