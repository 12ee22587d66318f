"""The chunk-parallel ``ssd_scan``: its launch plan (three passes, their
grids and f32 scratch) at the xLSTM serve shapes, at a ragged S and at the
normaliser's dv 1; the masked-last-chunk identity the kernels rely on,
held against the JAX package; and — on a machine with an NVIDIA GPU — the
three passes against the plain version, run twice bit for bit.

Inputs come from numpy with a fixed seed and go to both packages. The
identity is exact arithmetic (zero steps add nothing and decay by
exp(0) = 1), so the padded chunked program holds the unpadded sequential
reference to f32 rounding, 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

SMS = 132  # the H100's streaming multiprocessors


def test_three_kernels_a_call():
    assert ssd.KERNELS_PER_CALL == 3


@pytest.mark.parametrize("s", [1024, 1000])
def test_plan_at_the_serve_values_shape(s):
    plan = ssd.launch_plan(1, s, 4, 512, 512, 128)
    # 3 lower-triangle score tiles x 4 dk slices + 8 x 4 state tiles; a thread
    # per 4 state elements; 2 x 4 output tiles; 8 chunks, 4 heads
    assert plan["grids"] == ((44, 8, 4), (256, 4, 1), (8, 8, 4))
    assert (plan["tile_n"], plan["score_parts"], plan["score_blocks"]) == (128, 4, 12)
    assert plan["narrow"] is False
    assert plan["scratch"] == {"scores": (1, 4, 8, 4, 128, 128),
                               "states": (1, 4, 8, 512, 512), "bcum": (1, 4, 8, 128)}


@pytest.mark.parametrize("s", [1024, 1000])
def test_plan_at_the_normaliser_shape(s):
    """dv 1: the scores dominate and spread over score blocks; the output
    pass takes a warp per step."""
    plan = ssd.launch_plan(1, s, 4, 512, 1, 128)
    assert plan["grids"] == ((20, 8, 4), (1, 4, 1), (16, 8, 4))
    assert (plan["tile_n"], plan["score_parts"], plan["score_blocks"]) == (64, 4, 12)
    assert plan["narrow"] is True
    assert plan["scratch"]["states"] == (1, 4, 8, 512, 1)


@pytest.mark.parametrize("dv", [512, 1])
def test_serve_passes_fill_the_card(dv):
    """Each parallel pass has at least a block per SM at the serve shapes,
    and so have the dv 1 call's score blocks alone."""
    plan = ssd.launch_plan(1, 1024, 4, 512, dv, 128)
    chunk_pass, _, out_pass = plan["grids"]
    assert np.prod(chunk_pass) >= SMS and np.prod(out_pass) >= SMS
    assert plan["score_blocks"] * 8 * 4 >= SMS


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,want", [
    (2, 256, 2, 64, 64, 64, ((2, 4, 4), (4, 4, 1), (1, 4, 4))),
    (1, 37, 2, 24, 40, 16, ((2, 3, 2), (1, 2, 1), (1, 3, 2))),
    (2, 50, 3, 8, 3, 8, ((2, 7, 6), (1, 6, 1), (1, 7, 6))),
    (1, 200, 2, 300, 5, 24, ((8, 9, 2), (2, 2, 1), (1, 9, 2))),
])
def test_plan_at_small_and_ragged_shapes(b, s, h, dk, dv, chunk, want):
    assert ssd.launch_plan(b, s, h, dk, dv, chunk)["grids"] == want


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (1, 1024, 4, 512, 512, 128), (1, 1024, 4, 512, 1, 128), (2, 50, 3, 8, 3, 8),
])
def test_scratch_is_what_the_plan_names(b, s, h, dk, dv, chunk):
    plan = ssd.launch_plan(b, s, h, dk, dv, chunk)
    n = -(-s // chunk)
    assert plan["scratch"]["scores"] == (b, h, n, plan["score_parts"], chunk, chunk)
    assert plan["scratch"]["states"] == (b, h, n, dk, dv)
    assert plan["scratch"]["bcum"] == (b, h, n, chunk)


def _inputs(b, s, h, dk, dv, seed=0):
    rng = np.random.default_rng(seed + 11 * s + dk + 3 * dv)
    q = rng.normal(size=(b, s, h, dk)).astype(np.float32)
    k = (rng.normal(size=(b, s, h, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    g = (-np.abs(rng.normal(size=(b, s, h))) * 0.05).astype(np.float32)
    return q, k, v, g


def _pad(x, s_pad):
    width = [(0, 0)] * x.ndim
    width[1] = (0, s_pad - x.shape[1])
    return np.pad(x, width)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (1, 100, 2, 16, 8, 32), (2, 37, 1, 8, 1, 16), (1, 129, 2, 32, 16, 64),
])
def test_masked_last_chunk_identity(b, s, h, dk, dv, chunk):
    """Zero q, k, v and g = 0 past S, padded to a chunk multiple, leave y
    and the final state of the sequential reference on the unpadded input."""
    q, k, v, g = _inputs(b, s, h, dk, dv)
    want_y, want_h = ref.gla_reference(*map(jnp.asarray, (q, k, v, g)))
    s_pad = -(-s // chunk) * chunk
    padded = [_pad(x, s_pad) for x in (q, k, v, g)]
    y, h_t = ssd.ssd_scan_plain(*map(torch.from_numpy, padded), chunk=chunk)
    np.testing.assert_allclose(y[:, :s].numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    jy, jh = ops.ssd_scan(*map(jnp.asarray, padded), chunk=chunk, interpret=True)
    np.testing.assert_allclose(np.asarray(jy)[:, :s], np.asarray(want_y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(jh), np.asarray(want_h), atol=1e-5, rtol=1e-5)


_MIXED = (torch.bfloat16, torch.float32, torch.bfloat16)
_F32 = (torch.float32,) * 3
# (b, s, h, dk, dv, chunk), dtypes of q, k, v, non-zero h0: the serve shapes,
# a ragged S, the wide/narrow output boundary (dv 4, 5), one tile width
# boundary (dv 64, 65), dk not a multiple of the score slice, chunk 8
CUDA_CASES = [
    ((1, 1024, 4, 512, 512, 128), _MIXED, False),
    ((1, 1024, 4, 512, 1, 128), _MIXED, False),
    ((1, 1000, 4, 512, 512, 128), _MIXED, True),
    ((1, 200, 2, 40, 4, 32), _F32, True),
    ((1, 200, 2, 300, 5, 24), _MIXED, True),
    ((2, 256, 2, 64, 64, 64), _F32, True),
    ((1, 130, 2, 200, 65, 128), _F32, False),
    ((2, 50, 3, 8, 3, 8), _MIXED, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtypes,with_h0", CUDA_CASES)
def test_cuda_passes_match_plain_bit_for_bit_repeatable(shape, dtypes, with_h0):
    """f32 y and h_final to 1e-4 of their largest magnitude; a bf16 y to one
    bf16 ulp of the element plus 1e-5 of the largest; a second run equal
    bit for bit; the library's plan equal to launch_plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ssd_scan kernels)")
    b, s, h, dk, dv, chunk = shape
    arrays = _inputs(b, s, h, dk, dv)
    q, k, v = (torch.from_numpy(a).to("cuda", dt) for a, dt in zip(arrays[:3], dtypes))
    g = torch.from_numpy(arrays[3]).cuda()
    h0 = torch.randn(b, h, dk, dv, device="cuda") if with_h0 else None
    ssd.reset_launches()
    y, h_t = ssd.ssd_scan(q, k, v, g, h0, chunk)
    y2, h2 = ssd.ssd_scan(q, k, v, g, h0, chunk)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == 2
    assert torch.equal(y, y2) and torch.equal(h_t, h2)
    want_y, want_h = ssd.ssd_scan_plain(q, k, v, g, h0, chunk)
    yf, wf = y.float(), want_y.float()
    scale = float(wf.abs().max())
    allowed = 1e-4 * scale
    if v.dtype == torch.bfloat16:
        allowed = 2.0 ** -7 * torch.maximum(yf.abs(), wf.abs()) + 1e-5 * scale
    assert bool(((yf - wf).abs() <= allowed).all())
    assert float((h_t - want_h).abs().max()) <= 1e-4 * float(want_h.abs().max())
    plan = ssd.launch_plan(*shape)
    assert ssd.kernel_plan(*shape) == {key: plan[key]
                                       for key in ("grids", "tile_n", "score_parts")}
