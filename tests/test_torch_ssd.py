"""The PyTorch port's chunked GLA scan (``ssd_scan``): its plain version
against the JAX reference's Pallas kernel (interpret mode), its jnp oracle
and its XLA twin ``chunked_gla``; the wrapper's contract (zero sizes, input
checks, routing, launch counts); and — on a machine with an NVIDIA GPU —
the CUDA kernel against its plain version.

Inputs come from numpy with a fixed seed and go to both packages.
Tolerances are those of ``tests/test_kernels.py``: y to f32 atol and rtol
2e-5 (the sums run in other orders) or bf16 3e-2 (y is rounded to bf16
once, after an f32 accumulation, by either side), and h_final to atol 1e-4,
rtol 1e-3. Against the XLA twin, which runs the same chunk program, y and
h_final agree to 2e-5 and 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as S

# b, s, h, dk, dv, chunk: the reference's kernel-test shapes (SSD_CASES of
# tests/test_kernels.py) and the mLSTM normaliser's dv = 1
CASES = [
    (1, 128, 1, 32, 32, 32),
    (2, 256, 2, 64, 64, 64),
    (1, 256, 4, 32, 128, 128),
    (2, 128, 2, 128, 64, 128),
    (1, 128, 2, 32, 1, 32),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
Y_TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
H_TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(b, s, h, dk, dv, seed=0):
    """q, k (scaled by 0.3), v, and log decays -|N| * 0.05, as float32 numpy."""
    rng = np.random.default_rng(seed + s + 7 * dk + 31 * dv + h)
    q = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    k = (rng.normal(size=(b, s, h, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    g = (-np.abs(rng.normal(size=(b, s, h))) * 0.05).astype(np.float32)
    return q, k, v, g


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,dk,dv,chunk", CASES)
def test_plain_matches_pallas_and_reference(b, s, h, dk, dv, chunk, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, g = _inputs(b, s, h, dk, dv)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    y, h_t = ssd.ssd_scan_plain(tq, tk, tv, torch.from_numpy(g), chunk=chunk)
    assert y.shape == (b, s, h, dv) and y.dtype == tdt
    assert h_t.shape == (b, h, dk, dv) and h_t.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    kernel = ops.ssd_scan(jq, jk, jv, jnp.asarray(g), chunk=chunk, interpret=True)
    oracle = ref.gla_reference(jq, jk, jv, jnp.asarray(g))
    for want_y, want_h in (kernel, oracle):
        np.testing.assert_allclose(_np(y), _np(want_y), **Y_TOL[dtype])
        np.testing.assert_allclose(_np(h_t), _np(want_h), **H_TOL)


@pytest.mark.parametrize("impl", S.GLA_IMPLS)
def test_chunked_gla_from_a_state_matches_the_xla_twin(impl):
    q, k, v, g = _inputs(2, 96, 2, 32, 48)
    h0 = np.random.default_rng(9).normal(size=(2, 2, 32, 48)).astype(np.float32)
    want_y, want_h = JS.chunked_gla(*map(jnp.asarray, (q, k, v, g, h0)), chunk=32)
    y, h_t = S.chunked_gla(*map(torch.from_numpy, (q, k, v, g, h0)), chunk=32, impl=impl)
    np.testing.assert_allclose(y.numpy(), _np(want_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h_t.numpy(), _np(want_h), atol=1e-5, rtol=1e-5)


def test_ragged_s_takes_the_sequential_scan_as_the_reference():
    """S % chunk != 0: both sides fall back to the sequential recurrence."""
    q, k, v, g = _inputs(1, 50, 2, 16, 8)
    h0 = np.random.default_rng(10).normal(size=(1, 2, 16, 8)).astype(np.float32)
    want_y, want_h = JS.chunked_gla(*map(jnp.asarray, (q, k, v, g, h0)), chunk=16)
    y, h_t = S.chunked_gla(*map(torch.from_numpy, (q, k, v, g, h0)), chunk=16)
    np.testing.assert_allclose(y.numpy(), _np(want_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h_t.numpy(), _np(want_h), atol=1e-5, rtol=1e-5)
    seq_y, seq_h = ssd.gla_scan_plain(*map(torch.from_numpy, (q, k, v, g, h0)))
    assert torch.equal(seq_y, y) and torch.equal(seq_h, h_t)


@pytest.mark.parametrize("gval", [0.0, -30.0])
def test_decay_extremes(gval):
    """g = 0 (no decay: a running sum) and g = -30 (memoryless)."""
    b, s, h, dk, dv = 1, 128, 1, 16, 16
    q = np.full((b, s, h, dk), 0.1, np.float32)
    k = np.full((b, s, h, dk), 0.1, np.float32)
    v = np.random.default_rng(11).normal(size=(b, s, h, dv)).astype(np.float32)
    g = np.full((b, s, h), gval, np.float32)
    y, _ = ssd.ssd_scan(*map(torch.from_numpy, (q, k, v, g)), chunk=32)
    want, _ = ref.gla_reference(*map(jnp.asarray, (q, k, v, g)))
    np.testing.assert_allclose(y.numpy(), _np(want), atol=1e-4)


def test_decode_step_matches():
    rng = np.random.default_rng(12)
    q, k = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(2, 3, 5)).astype(np.float32)
    g = -np.abs(rng.normal(size=(2, 3))).astype(np.float32)
    h = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    want_y, want_h = JS.gla_decode_step(*map(jnp.asarray, (q, k, v, g, h)))
    y, h_t = S.gla_decode_step(*map(torch.from_numpy, (q, k, v, g, h)))
    np.testing.assert_allclose(y.numpy(), _np(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), _np(want_h), atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    q, k, v, g = map(torch.from_numpy, _inputs(1, 64, 2, 16, 16))
    ssd.reset_launches()
    y, h_t = ssd.ssd_scan(q, k, v, g, chunk=16)
    want_y, want_h = ssd.ssd_scan_plain(q, k, v, g, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(h_t, want_h)
    S.chunked_gla(q, k, v, g, chunk=16)
    assert ssd.LAUNCHES["ssd_scan"] == 0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(1, 0, 2, 16, 8), (0, 8, 2, 16, 8), (1, 8, 2, 16, 0)])
def test_zero_size_short_circuits(shape, with_h0):
    """An empty sequence returns an empty y and leaves the state at h0."""
    b, s, h, dk, dv = shape
    h0 = torch.randn(b, h, dk, dv) if with_h0 else None
    ssd.reset_launches()
    y, h_t = ssd.ssd_scan(torch.ones(b, s, h, dk), torch.ones(b, s, h, dk),
                          torch.ones(b, s, h, dv, dtype=torch.bfloat16),
                          torch.zeros(b, s, h), h0)
    assert y.shape == (b, s, h, dv) and y.dtype == torch.bfloat16 and not y.any()
    assert torch.equal(h_t, h0 if with_h0 else torch.zeros(b, h, dk, dv))
    assert ssd.LAUNCHES["ssd_scan"] == 0


def _args(**over):
    a = dict(q=torch.zeros(1, 8, 2, 16), k=torch.zeros(1, 8, 2, 16),
             v=torch.zeros(1, 8, 2, 4), g=torch.zeros(1, 8, 2), h0=None)
    a.update(over)
    return a


@pytest.mark.parametrize("over,exc,match", [
    (dict(q=torch.zeros(1, 8, 2, 16, dtype=torch.float16)), TypeError, "q must be one of"),
    (dict(v=torch.zeros(1, 8, 2, 4, dtype=torch.float64)), TypeError, "v must be one of"),
    (dict(g=torch.zeros(1, 8, 2, dtype=torch.bfloat16)), TypeError, "g must be float32"),
    (dict(k=torch.zeros(1, 8, 2, 8)), ValueError, r"q, k must be \[B, S, H, dk\]"),
    (dict(g=torch.zeros(1, 8, 3)), ValueError, "g"),
    (dict(q=torch.zeros(8, 2, 16)), ValueError, "4-d"),
    (dict(h0=torch.zeros(1, 2, 16, 5)), ValueError, "h0 must be"),
    (dict(h0=torch.zeros(1, 2, 16, 4, dtype=torch.bfloat16)), ValueError, "h0 must be"),
    (dict(q=torch.zeros(1, 8, 2, 16, device="meta"),
          k=torch.zeros(1, 8, 2, 16, device="meta"),
          v=torch.zeros(1, 8, 2, 4, device="meta"),
          g=torch.zeros(1, 8, 2, device="meta")), ValueError, "cuda or cpu"),
    (dict(g=torch.zeros(1, 8, 2, device="meta")), ValueError, "one device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(over, exc, match):
    a = _args(**over)
    with pytest.raises(exc, match=match):
        ssd.ssd_scan(a["q"], a["k"], a["v"], a["g"], a["h0"])


def test_unknown_gla_impl_raises():
    q, k, v, g = map(torch.from_numpy, _inputs(1, 16, 1, 8, 8))
    with pytest.raises(ValueError, match="gla_impl"):
        S.chunked_gla(q, k, v, g, chunk=16, impl="pallas")


# label, (b, s, h, dk, dv, chunk), dtypes of q, k, v, non-zero h0: the xLSTM
# serve shapes in the mLSTM's dtypes (q bf16, k f32, v bf16), a ragged S, a
# continued prefill and the reference's kernel-test shapes
_MIXED = (torch.bfloat16, torch.float32, torch.bfloat16)
CUDA_CASES = [
    ("serve values", (1, 1024, 4, 512, 512, 128), _MIXED, False),
    ("serve normaliser", (1, 1024, 4, 512, 1, 128), _MIXED, False),
    ("ragged S", (1, 1000, 4, 512, 64, 128), _MIXED, False),
    ("non-zero h0", (2, 256, 2, 64, 64, 64), (torch.float32,) * 3, True),
] + [(f"kernel test {dt}", shape, (dt,) * 3, False)
     for shape in CASES for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,shape,dtypes,with_h0", CUDA_CASES,
                         ids=[c[0].replace(" ", "-") + str(i) for i, c in enumerate(CUDA_CASES)])
def test_cuda_kernel_matches_plain(label, shape, dtypes, with_h0):
    """f32 y and h_final to 1e-4 of their largest magnitude; a bf16 y to one
    bf16 ulp of the element (2**-7 of it) plus 1e-5 of the largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA ssd_scan kernel)")
    b, s, h, dk, dv, chunk = shape
    arrays = _inputs(b, s, h, dk, dv)
    q, k, v = (torch.from_numpy(a).to("cuda", dt) for a, dt in zip(arrays[:3], dtypes))
    g = torch.from_numpy(arrays[3]).cuda()
    h0 = torch.randn(b, h, dk, dv, device="cuda") if with_h0 else None
    before = ssd.LAUNCHES["ssd_scan"]
    y, h_t = ssd.ssd_scan(q, k, v, g, h0, chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == before + 1
    want_y, want_h = ssd.ssd_scan_plain(q, k, v, g, h0, chunk)
    yf, wf = y.float(), want_y.float()
    scale = float(wf.abs().max())
    allowed = 1e-4 * scale
    if v.dtype == torch.bfloat16:
        allowed = 2.0 ** -7 * torch.maximum(yf.abs(), wf.abs()) + 1e-5 * scale
    assert bool(((yf - wf).abs() <= allowed).all())
    assert float((h_t - want_h).abs().max()) <= 1e-4 * float(want_h.abs().max())
