"""The PyTorch port's Mamba-2 mixer (``repro_torch.models.ssm``) against the
JAX reference's (``repro.models.ssm``) on the same parameters and inputs,
made from numpy with a fixed seed, all f32: the depthwise causal conv and
its one-step form, ``Mamba2.forward`` from zeros and from an ``(h0, conv0)``
state at a prompt length the chunk divides (the chunked program) and one it
does not (the sequential scan), 8 decode steps, and the plain GLA scan with
q as a stride-0 view over the heads (how Mamba-2 passes its one group of
C). Everything agrees within 2e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as S

TOL = dict(atol=2e-5, rtol=2e-5)
DIMS = JS.Mamba2Dims.make(32, 16, 2, 16)  # d_inner 64, 4 heads of 16, state 16
N_DECODE = 8


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _port_mamba(p, dims=DIMS):
    m = S.Mamba2(S.Mamba2Dims(*dims), torch.float32)
    with torch.no_grad():
        for n in ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj"):
            getattr(m, n).weight.copy_(_t(p[n]).t())
        for n in ("conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "A_log", "D", "dt_bias",
                  "norm_g"):
            getattr(m, n).copy_(_t(p[n]))
    return m


@pytest.fixture(scope="module")
def mixer():
    """(reference params, the port's mixer on them); the conv biases and
    ``D`` are moved off their init values so that they count."""
    p = JS.mamba2_init(jax.random.PRNGKey(1), DIMS, jnp.float32)
    rng = np.random.default_rng(2)
    for n in ("conv_b_x", "conv_b_bc", "D"):
        p[n] = jnp.asarray(rng.normal(size=p[n].shape), jnp.float32)
    return p, _port_mamba(p)


# ---------------------------------------------------------------- conv

@pytest.mark.parametrize("s", [1, 3, 17])
def test_causal_conv_matches(s):
    rng = np.random.default_rng(s)
    x, w, b = rng.normal(size=(2, s, 6)), rng.normal(size=(4, 6)), rng.normal(size=6)
    want = JS.causal_conv(*(jnp.asarray(a, jnp.float32) for a in (x, w, b)))
    _close(S.causal_conv(_t(x), _t(w), _t(b)), want)


def test_causal_conv_step_matches():
    rng = np.random.default_rng(4)
    x, cache, w, b = (rng.normal(size=shape) for shape in ((2, 6), (2, 3, 6), (4, 6), (6,)))
    want_y, want_cache = JS.causal_conv_step(*(jnp.asarray(a, jnp.float32)
                                               for a in (x, cache, w, b)))
    got_y, got_cache = S.causal_conv_step(_t(x), _t(cache), _t(w), _t(b))
    _close(got_y, want_y)
    _close(got_cache, want_cache)


# ---------------------------------------------------------------- mixer

def test_init_draws_the_reference_distributions():
    m = S.Mamba2(S.Mamba2Dims(*DIMS), torch.float32).requires_grad_(False)
    m.init(torch.Generator().manual_seed(0))
    p = JS.mamba2_init(jax.random.PRNGKey(0), DIMS, jnp.float32)
    _close(m.A_log, p["A_log"])
    assert torch.equal(m.D, torch.ones(DIMS.n_heads))
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5))).all())
    assert not m.conv_b_x.any() and not m.conv_b_bc.any()
    assert abs(float(m.conv_w_x.std()) - 1 / math.sqrt(DIMS.conv_k)) < 0.1
    assert sum(t.numel() for t in m.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(p))


@pytest.mark.parametrize("s,chunk", [(32, 8), (20, 8)])
@pytest.mark.parametrize("from_state", [False, True])
def test_forward_matches(mixer, s, chunk, from_state):
    p, m = mixer
    rng = np.random.default_rng(20 + s)
    x = rng.normal(size=(2, s, DIMS.d_model)).astype(np.float32)
    h0 = conv0 = None
    if from_state:
        hs, (cxs, cbcs) = JS.mamba2_state_shape(DIMS, 2)
        h0 = (rng.normal(size=hs) * 0.1).astype(np.float32)
        conv0 = tuple(rng.normal(size=sh).astype(np.float32) for sh in (cxs, cbcs))
    want, (wh, (wcx, wcbc)) = JS.mamba2_apply(
        p, jnp.asarray(x), DIMS, None if h0 is None else jnp.asarray(h0),
        None if conv0 is None else tuple(map(jnp.asarray, conv0)), chunk=chunk)
    with torch.no_grad():
        got, (gh, (gcx, gcbc)) = m(_t(x), None if h0 is None else _t(h0),
                                   None if conv0 is None else tuple(map(_t, conv0)), chunk)
    for a, b in ((got, want), (gh, wh), (gcx, wcx), (gcbc, wcbc)):
        assert a.shape == b.shape
        _close(a, b)


def test_decode_matches(mixer):
    """A 12-token prompt, then 8 one-token steps from its state."""
    p, m = mixer
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 12, DIMS.d_model)).astype(np.float32)
    _, jstate = JS.mamba2_apply(p, jnp.asarray(x), DIMS, chunk=4)
    with torch.no_grad():
        _, state = m(_t(x), chunk=4)
        for _ in range(N_DECODE):
            xt = rng.normal(size=(2, DIMS.d_model)).astype(np.float32)
            want, jstate = JS.mamba2_decode(p, jnp.asarray(xt), DIMS, jstate)
            got, state = m.decode(_t(xt), state)
            _close(got, want)
            _close(state[0], jstate[0])
            for a, b in zip(state[1], jstate[1]):
                _close(a, b)


# ---------------------------------------------------------------- GLA core

@pytest.mark.parametrize("s,chunk", [(32, 8), (20, 8)])
def test_plain_gla_takes_a_stride_0_q(s, chunk):
    """q = C broadcast over the heads, as an expanded view: the plain route
    equals the reference's ``chunked_gla`` on the broadcast array and the
    port's own run on a contiguous copy, bit for bit."""
    b, h, dk, dv = 2, 4, 8, 6
    rng = np.random.default_rng(40 + s)
    c = rng.normal(size=(b, s, dk)).astype(np.float32)
    k = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    g = -np.abs(rng.normal(size=(b, s, h))).astype(np.float32)
    q = _t(c)[:, :, None, :].expand(b, s, h, dk)
    assert q.stride(2) == 0
    want_y, want_h = JS.chunked_gla(
        jnp.broadcast_to(jnp.asarray(c)[:, :, None, :], (b, s, h, dk)),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(g), chunk=chunk)
    y, hT = S.chunked_gla(q, _t(k), _t(v), _t(g), None, chunk, "plain")
    _close(y, want_y)
    _close(hT, want_h)
    y2, h2 = S.chunked_gla(q.contiguous(), _t(k), _t(v), _t(g), None, chunk, "auto")
    assert torch.equal(y, y2) and torch.equal(hT, h2)


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32, torch.bfloat16),
                                    (torch.float32,) * 3])
def test_cuda_ssd_scan_at_the_mamba2_shape_matches_plain(dtypes):
    """zamba2-2.7b's scan: B 1, S 1024, H 80, dk = dv = 64, chunk 128, q a
    stride-0 view of C over the heads, in Mamba-2's dtypes (q and v bf16, k
    f32) and in f32; y and h_final within 1e-4 of their largest magnitude
    (a bf16 y within one bf16 ulp more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    b, s, h, n, hd, chunk = 1, 1024, 80, 64, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn((b, s, n), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 4)
    q = c.to(dtypes[0])[:, :, None, :].expand(b, s, h, n)
    k = (torch.randn((b, s, 1, n), generator=gen, device="cuda") * dt[..., None]).to(dtypes[1])
    v = torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtypes[2])
    g = dt * -torch.linspace(1.0, 16.0, h, device="cuda")
    ssd.reset_launches()
    y, hT = ssd.ssd_scan(q, k, v, g, None, chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == 1
    y_p, h_p = ssd.ssd_scan_plain(q, k, v, g, None, chunk)
    scale = float(y_p.float().abs().max())
    allowed = 1e-4 * scale + (2.0 ** -7 * y_p.float().abs() if v.dtype == torch.bfloat16 else 0)
    assert bool(((y.float() - y_p.float()).abs() <= allowed).all())
    assert float((hT - h_p).abs().max()) <= 1e-4 * float(h_p.abs().max())
