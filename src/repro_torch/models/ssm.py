"""The recurrent mixers on PyTorch: the GLA core, Mamba-2, the mLSTM and the
sLSTM.

The reference's ``models/ssm.py``, with its cast points kept: Mamba-2's k
(``B * dt``) is f32 while q (``C``, broadcast over the heads) and v (the
conv output) keep the model dtype, and its ``D`` skip promotes y to f32
through the gated norm and ``out_proj``; the mLSTM's k is promoted to f32
by its input gate, its normaliser ``q·n_t`` is rounded to v's dtype before
``max(|·|, 1)``; the sLSTM's gates run in f32. Mamba-2 is the mixer of the
``zamba_super`` block (``zamba2-2.7b``), the mLSTM and the sLSTM those of
``xlstm_pair`` (``xlstm-350m``); each is also a block of its own, a
``mamba2``, ``mlstm`` or ``slstm`` stage of a block program. Every mixer
takes an initial state (None: zeros, :func:`slstm_zero_state` for the
sLSTM, whose ``m`` starts at -10), so a prefill continues a state and
``decode`` steps it one token.

GLA routes (``gla_impl``):

* ``"auto"`` — :func:`chunked_gla` goes to :func:`repro_torch.kernels.
  ssd_scan.ssd_scan`: the CUDA kernel on a CUDA tensor, its plain version
  (the reference's ``chunked_gla`` program) on a CPU tensor;
* ``"plain"`` — the plain version everywhere.

Decode (:func:`gla_decode_step`) is one plain recurrent step, as the
reference computes it outside any kernel, and so is Mamba-2's depthwise
causal conv (:func:`causal_conv`, :func:`causal_conv_step`). The sLSTM is a
strictly sequential scan: a Python loop over positions, one cell step each.
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
# depthwise causal conv (Mamba front conv)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w: [K,C] depthwise; returns [B,S,C] (causal, left-padded)."""
    kk, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, kk - 1, 0))
    out = xp[:, :s] * w[0]
    for i in range(1, kk):
        out = out + xp[:, i:i + s] * w[i]
    return out + bias


def causal_conv_step(x_t, conv_cache, w, bias):
    """x_t: [B,C]; conv_cache: [B,K-1,C] (previous inputs). Returns (y, cache)."""
    full = torch.cat([conv_cache, x_t[:, None, :]], 1)  # [B,K,C]
    y = (full * w).sum(1) + bias
    return y, full[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba-2 mixer
# ---------------------------------------------------------------------------

class Mamba2Dims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_k: int

    @staticmethod
    def make(d_model: int, d_state: int, expand: int = 2, head_dim: int = 64,
             conv_k: int = 4) -> "Mamba2Dims":
        d_inner = expand * d_model
        return Mamba2Dims(d_model, d_inner, d_inner // head_dim, head_dim, d_state, conv_k)


def mamba2_state_shape(dims: Mamba2Dims, batch: int):
    """(h, (conv_x, conv_bc)) shapes of one layer's decode state."""
    return (
        (batch, dims.n_heads, dims.d_state, dims.head_dim),
        (
            (batch, dims.conv_k - 1, dims.d_inner),
            (batch, dims.conv_k - 1, 2 * dims.d_state),
        ),
    )


def _last_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last ``k`` positions of x ``[B, S, C]``, zero-padded in front."""
    return F.pad(x, (0, 0, max(k - x.shape[1], 0), 0))[:, -k:]


class Mamba2(nn.Module):
    """The Mamba-2 (SSD) mixer (the reference's ``mamba2_init``/
    ``mamba2_apply``/``mamba2_decode``): the separate projections ``z_proj``,
    ``x_proj``, ``bc_proj`` and ``dt_proj`` (``nn.Linear``s, the reference's
    ``[in, out]`` arrays transposed), the depthwise conv ``conv_w_*`` ``[K,
    C]`` and ``conv_b_*``, one group of B and C shared by every head, and
    f32 ``A_log``, ``D`` and ``dt_bias`` ``[H]``."""

    def __init__(self, dims: Mamba2Dims, dtype):
        super().__init__()
        self.dims = dims
        d, di, n, h, kk = dims.d_model, dims.d_inner, dims.d_state, dims.n_heads, dims.conv_k
        self.z_proj = _linear(d, di, dtype)
        self.x_proj = _linear(d, di, dtype)
        self.bc_proj = _linear(d, 2 * n, dtype)
        self.dt_proj = _linear(d, h, dtype)
        self.conv_w_x = nn.Parameter(torch.zeros((kk, di), dtype=dtype))
        self.conv_b_x = nn.Parameter(torch.zeros(di, dtype=dtype))
        self.conv_w_bc = nn.Parameter(torch.zeros((kk, 2 * n), dtype=dtype))
        self.conv_b_bc = nn.Parameter(torch.zeros(2 * n, dtype=dtype))
        self.A_log = nn.Parameter(torch.zeros(h, dtype=torch.float32))
        self.D = nn.Parameter(torch.ones(h, dtype=torch.float32))
        self.dt_bias = nn.Parameter(torch.zeros(h, dtype=torch.float32))
        self.norm_g = nn.Parameter(torch.ones(di, dtype=dtype))
        self.out_proj = _linear(di, d, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``mamba2_init``, drawn in its key order: dt bias
        ``softplus^-1`` of dt log-uniform in [1e-3, 1e-1], ``A_log =
        log(linspace(1, 16))``, ``D`` 1, conv weights normal over sqrt(K)."""
        for lin in (self.z_proj, self.x_proj, self.bc_proj, self.dt_proj):
            _init_linear(lin, generator)
        kk = self.dims.conv_k
        for w in (self.conv_w_x, self.conv_w_bc):
            r = torch.randn(w.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            w.copy_((r / math.sqrt(kk)).to(w.dtype))
        self.conv_b_x.zero_()
        self.conv_b_bc.zero_()
        h = self.dims.n_heads
        u = torch.rand(h, generator=generator, dtype=torch.float32, device=generator.device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32)))
        self.D.fill_(1.0)
        self.norm_g.fill_(1.0)
        _init_linear(self.out_proj, generator)

    def _gates(self, dt_raw, bc):
        """(B, C, dt, g) from the conv's ``bc`` and ``dt_raw``: dt =
        softplus(dt_raw + dt_bias) and g = dt * -exp(A_log) f32."""
        n = self.dims.d_state
        dt = F.softplus(dt_raw.float() + self.dt_bias)
        return bc[..., :n], bc[..., n:], dt, dt * -torch.exp(self.A_log)

    def _out(self, y, xin, z, x_dtype, eps: float):
        """``y + D * x``, gated by ``silu(z)``, RMS norm and ``out_proj``, in
        the reference's types: f32 from the skip on, cast back at the end."""
        y = y + xin * self.D[:, None]
        y = y.reshape(*y.shape[:-2], self.dims.d_inner)
        y = rms_norm(y * F.silu(z), self.norm_g, eps)
        return F.linear(y, self.out_proj.weight.to(y.dtype)).to(x_dtype)

    def forward(self, x, h0=None, conv0=None, chunk: int = DEFAULT_GLA_CHUNK,
                eps: float = 1e-5, gla_impl: str = "auto"):
        """x ``[B, S, D]`` -> (y, (h_final, (conv_x, conv_bc))); ``h0``
        ``[B, H, N, hd]`` f32 and ``conv0`` (the last K-1 inputs of each conv)
        continue a sequence, None starts from zeros."""
        b, s, _ = x.shape
        dims = self.dims

        def conv_branch(raw, w, bias, cache):
            if cache is not None:
                xp = torch.cat([cache.to(raw.dtype), raw], 1)
                out = causal_conv(xp, w, bias)[:, cache.shape[1]:]
                tail = xp[:, -(dims.conv_k - 1):]
            else:
                out = causal_conv(raw, w, bias)
                tail = _last_k(raw, dims.conv_k - 1)
            return F.silu(out), tail

        cx0, cbc0 = conv0 if conv0 is not None else (None, None)
        xin, new_cx = conv_branch(self.x_proj(x), self.conv_w_x, self.conv_b_x, cx0)
        bc, new_cbc = conv_branch(self.bc_proj(x), self.conv_w_bc, self.conv_b_bc, cbc0)
        B, C, dt, g = self._gates(self.dt_proj(x), bc)
        xin = xin.reshape(b, s, dims.n_heads, dims.head_dim)
        k = B[:, :, None, :] * dt[..., None]  # [B,S,H,N] f32: dt absorbed into k
        q = C[:, :, None, :].expand(b, s, dims.n_heads, dims.d_state)  # a stride-0 head axis
        y, hT = chunked_gla(q, k, xin, g, h0, chunk, gla_impl)
        return self._out(y, xin, self.z_proj(x), x.dtype, eps), (hT, (new_cx, new_cbc))

    def decode(self, x_t, state, eps: float = 1e-5):
        """x_t ``[B, D]`` -> (y ``[B, D]``, (h, (conv_x, conv_bc))), one
        recurrent step."""
        h, (conv_x, conv_bc) = state
        b = x_t.shape[0]
        dims = self.dims
        xraw, bcraw = self.x_proj(x_t), self.bc_proj(x_t)
        xin, conv_x = causal_conv_step(xraw, conv_x.to(xraw.dtype), self.conv_w_x,
                                       self.conv_b_x)
        bc, conv_bc = causal_conv_step(bcraw, conv_bc.to(bcraw.dtype), self.conv_w_bc,
                                       self.conv_b_bc)
        B, C, dt, g = self._gates(self.dt_proj(x_t), F.silu(bc))
        xin = F.silu(xin).reshape(b, dims.n_heads, dims.head_dim)
        k = B[:, None, :] * dt[..., None]  # [B,H,N] f32
        q = C[:, None, :].expand(b, dims.n_heads, dims.d_state)
        y, h = gla_decode_step(q, k, xin, g, h)
        return self._out(y, xin, self.z_proj(x_t), x_t.dtype, eps), (h, (conv_x, conv_bc))


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
        b = x.shape[0]
        st = state if state is not None else slstm_zero_state(self.dims, b, x.device)
        hs, st = self.scan(self.w_in(x), st)  # x_gates [B,S,4di]
        y = rms_norm(hs.to(x.dtype), self.norm_g, eps)
        return self.out_proj(y), st

    def scan(self, x_gates: torch.Tensor, st: SLstmState) -> Tuple[torch.Tensor, SLstmState]:
        """One :meth:`cell` step a position of ``x_gates`` ``[B, S, 4 di]``:
        (h at every position ``[B, S, di]`` f32, the last state). The dry run
        (``launch/dryrun.py``) counts this loop by its trip count."""
        hs = []
        for t in range(x_gates.shape[1]):
            st = self.cell(x_gates[:, t], st)
            hs.append(st.h)
        return torch.stack(hs, 1), st

    def decode(self, x_t, state: SLstmState, eps: float = 1e-5):
        st = self.cell(self.w_in(x_t), state)
        y = rms_norm(st.h.to(x_t.dtype), self.norm_g, eps)
        return self.out_proj(y), st
