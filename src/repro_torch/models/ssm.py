"""xLSTM's recurrent mixers on PyTorch: the GLA core, the mLSTM and the sLSTM.

The xLSTM subset of the reference's ``models/ssm.py`` (Mamba-2 is ROADMAP
Queue 1 item 12c), with its cast points kept: the mLSTM's k is promoted to
f32 by its input gate, its normaliser ``q·n_t`` is rounded to v's dtype
before ``max(|·|, 1)``, and the sLSTM's gates run in f32.

GLA routes (``gla_impl``):

* ``"auto"`` — :func:`chunked_gla` goes to :func:`repro_torch.kernels.
  ssd_scan.ssd_scan`: the CUDA kernel on a CUDA tensor, its plain version
  (the reference's ``chunked_gla`` program) on a CPU tensor;
* ``"plain"`` — the plain version everywhere.

Decode (:func:`gla_decode_step`) is one plain recurrent step, as the
reference computes it outside any kernel. The sLSTM is a strictly
sequential scan: a Python loop over positions, one cell step each.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.layers import dense_init, rms_norm

DEFAULT_GLA_CHUNK = 128
GLA_IMPLS = ("auto", "plain")


# ---------------------------------------------------------------------------
# chunked GLA core
# ---------------------------------------------------------------------------

def chunked_gla(q, k, v, g, h0=None, chunk: int = DEFAULT_GLA_CHUNK,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(g_t) h_{t-1} + k_t ⊗ v_t``, ``y_t = q_t · h_t`` over
    q, k ``[B,S,H,dk]``, v ``[B,S,H,dv]``, g ``[B,S,H]``: (y, h_final)."""
    if impl not in GLA_IMPLS:
        raise ValueError(f"gla_impl must be one of {GLA_IMPLS}, got {impl!r}")
    if impl == "plain":
        return ssd_scan_plain(q, k, v, g, h0, chunk)
    return ssd_scan(q, k, v, g, h0, chunk)


def gla_decode_step(q, k, v, g, h):
    """One recurrent step. q,k: [B,H,dk]; v: [B,H,dv]; g: [B,H]; h: [B,H,dk,dv]."""
    h = torch.exp(g.float())[..., None, None] * h + torch.einsum(
        "bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", q.float(), h)
    return y.to(v.dtype), h


def _linear(d_in: int, d_out: int, dtype) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype)


def _init_linear(lin: nn.Linear, generator: torch.Generator) -> None:
    w = dense_init(generator, lin.in_features, lin.out_features, lin.weight.dtype)
    lin.weight.copy_(w.t())


# ---------------------------------------------------------------------------
# mLSTM — gated linear attention form
# ---------------------------------------------------------------------------

class MLstmDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int

    @staticmethod
    def make(d_model: int, n_heads: int, expand: int = 2) -> "MLstmDims":
        d_inner = expand * d_model
        return MLstmDims(d_model, d_inner, n_heads, d_inner // n_heads)


def mlstm_state_shape(dims: MLstmDims, batch: int):
    return (
        (batch, dims.n_heads, dims.head_dim, dims.head_dim),
        (batch, dims.n_heads, dims.head_dim, 1),
    )


class MLstm(nn.Module):
    """The mLSTM mixer (the reference's ``mlstm_init``/``mlstm_apply``/
    ``mlstm_decode``). Matrices are ``nn.Linear``s (the reference's ``[in,
    out]`` arrays transposed); ``w_if`` and ``b_if`` are f32."""

    def __init__(self, dims: MLstmDims, dtype):
        super().__init__()
        self.dims = dims
        di, h = dims.d_inner, dims.n_heads
        self.up_proj = _linear(dims.d_model, 2 * di, dtype)
        self.wq = _linear(di, di, dtype)
        self.wk = _linear(di, di, dtype)
        self.wv = _linear(di, di, dtype)
        self.w_if = _linear(di, 2 * h, torch.float32)
        self.b_if = nn.Parameter(torch.zeros(2 * h, dtype=torch.float32))
        self.norm_g = nn.Parameter(torch.ones(di, dtype=dtype))
        self.down_proj = _linear(di, dims.d_model, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``mlstm_init``: forget-gate bias 3 (long memory)."""
        for lin in (self.up_proj, self.wq, self.wk, self.wv, self.w_if):
            _init_linear(lin, generator)
        h = self.dims.n_heads
        self.b_if.copy_(torch.cat([torch.zeros(h), 3.0 * torch.ones(h)]))
        self.norm_g.fill_(1.0)
        _init_linear(self.down_proj, generator)

    def _qkvg(self, xin: torch.Tensor):
        b, s, _ = xin.shape
        h, hd = self.dims.n_heads, self.dims.head_dim
        q = self.wq(xin).reshape(b, s, h, hd) / math.sqrt(hd)
        k = self.wk(xin).reshape(b, s, h, hd)
        v = self.wv(xin).reshape(b, s, h, hd)
        if_raw = F.linear(xin.float(), self.w_if.weight) + self.b_if
        i_raw, f_raw = if_raw.chunk(2, dim=-1)  # [B,S,H]
        g = F.logsigmoid(f_raw)  # log decay <= 0
        return q, k * torch.sigmoid(i_raw)[..., None], v, g

    def _out(self, y, nq, z, x_dtype, eps: float):
        """Normalise by ``max(|q·n|, 1)``, gate by ``silu(z)``, RMS norm, project."""
        denom = torch.clamp(nq.float().abs(), min=1.0)
        y = (y.float() / denom).to(x_dtype)
        y = y.reshape(*y.shape[:-2], self.dims.d_inner)
        y = rms_norm(y * F.silu(z), self.norm_g, eps)
        return self.down_proj(y)

    def forward(self, x, state=None, chunk: int = DEFAULT_GLA_CHUNK, eps: float = 1e-5,
                gla_impl: str = "auto"):
        """x ``[B, S, D]`` -> (y, (h_final, n_final)); ``state``: (h ``[B, H,
        hd, hd]``, n ``[B, H, hd, 1]``) f32 or None (zeros)."""
        up = self.up_proj(x)
        xin, z = up.chunk(2, dim=-1)
        q, k, v, g = self._qkvg(xin)
        h0, n0 = state if state is not None else (None, None)
        y, hT = chunked_gla(q, k, v, g, h0, chunk, gla_impl)
        ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
        nq, nT = chunked_gla(q, k, ones, g, n0, chunk, gla_impl)  # denominator q.n_t
        return self._out(y, nq, z, x.dtype, eps), (hT, nT)

    def decode(self, x_t, state, eps: float = 1e-5):
        """x_t ``[B, D]`` -> (y ``[B, D]``, (h, n)), one recurrent step."""
        h, n = state
        up = self.up_proj(x_t[:, None, :])
        xin, z = up.chunk(2, dim=-1)
        q, k, v, g = self._qkvg(xin)
        q, k, v, g = q[:, 0], k[:, 0], v[:, 0], g[:, 0]
        y, h = gla_decode_step(q, k, v, g, h)
        ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
        nq, n = gla_decode_step(q, k, ones, g, n)
        return self._out(y, nq, z[:, 0], x_t.dtype, eps), (h, n)


# ---------------------------------------------------------------------------
# sLSTM — strictly sequential scalar-memory cell
# ---------------------------------------------------------------------------

class SLstmDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int

    @staticmethod
    def make(d_model: int, n_heads: int, expand: int = 1) -> "SLstmDims":
        d_inner = expand * d_model
        return SLstmDims(d_model, d_inner, n_heads, d_inner // n_heads)


class SLstmState(NamedTuple):
    c: torch.Tensor  # [B, di]
    n: torch.Tensor  # [B, di]
    m: torch.Tensor  # [B, di]
    h: torch.Tensor  # [B, di]


def slstm_zero_state(dims: SLstmDims, batch: int, device=None) -> SLstmState:
    z = torch.zeros((batch, dims.d_inner), dtype=torch.float32, device=device)
    return SLstmState(z, z, z - 10.0, z)


class SLstm(nn.Module):
    """The sLSTM mixer (the reference's ``slstm_init``/``slstm_apply``/
    ``slstm_decode``): block-diagonal recurrent weights ``r`` ``[H, hd,
    4 hd]`` in the model dtype, f32 gate bias ``b``."""

    def __init__(self, dims: SLstmDims, dtype):
        super().__init__()
        self.dims = dims
        di = dims.d_inner
        self.w_in = _linear(dims.d_model, 4 * di, dtype)
        self.r = nn.Parameter(torch.zeros((dims.n_heads, dims.head_dim, 4 * dims.head_dim),
                                          dtype=dtype))
        self.b = nn.Parameter(torch.zeros(4 * di, dtype=torch.float32))
        self.norm_g = nn.Parameter(torch.ones(di, dtype=dtype))
        self.out_proj = _linear(di, dims.d_model, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``slstm_init``: forget-gate bias 3."""
        _init_linear(self.w_in, generator)
        r = torch.randn(self.r.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        self.r.copy_((r / math.sqrt(self.dims.head_dim)).to(self.r.dtype))
        di = self.dims.d_inner
        self.b.copy_(torch.cat([torch.zeros(3 * di), 3.0 * torch.ones(di)]))
        self.norm_g.fill_(1.0)
        _init_linear(self.out_proj, generator)

    def cell(self, x_gates_t: torch.Tensor, st: SLstmState) -> SLstmState:
        """x_gates_t ``[B, 4 di]`` (the input's contribution): one
        stabilised exponential-gating step."""
        dims = self.dims
        b = st.h.shape[0]
        hh = st.h.reshape(b, dims.n_heads, dims.head_dim).to(self.r.dtype)
        rec = torch.einsum("bhd,hdf->bhf", hh, self.r).reshape(b, 4 * dims.d_inner)
        gates = x_gates_t.float() + rec.float() + self.b
        z_raw, i_raw, o_raw, f_raw = gates.chunk(4, dim=-1)
        z = torch.tanh(z_raw)
        o = torch.sigmoid(o_raw)
        f_log = F.logsigmoid(f_raw)
        m_new = torch.maximum(f_log + st.m, i_raw)
        i_p = torch.exp(i_raw - m_new)
        f_p = torch.exp(f_log + st.m - m_new)
        c = f_p * st.c + i_p * z
        n = f_p * st.n + i_p
        h = o * c / torch.clamp(n, min=1e-6)
        return SLstmState(c, n, m_new, h)

    def forward(self, x, state: Optional[SLstmState] = None, eps: float = 1e-5):
        """x ``[B, S, D]`` -> (y, final state), one cell step per position."""
        b, s, _ = x.shape
        st = state if state is not None else slstm_zero_state(self.dims, b, x.device)
        x_gates = self.w_in(x)  # [B,S,4di]
        hs = []
        for t in range(s):
            st = self.cell(x_gates[:, t], st)
            hs.append(st.h)
        y = torch.stack(hs, 1).to(x.dtype)
        y = rms_norm(y, self.norm_g, eps)
        return self.out_proj(y), st

    def decode(self, x_t, state: SLstmState, eps: float = 1e-5):
        st = self.cell(self.w_in(x_t), state)
        y = rms_norm(st.h.to(x_t.dtype), self.norm_g, eps)
        return self.out_proj(y), st
