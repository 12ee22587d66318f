"""The PyTorch port's flash attention: its plain version against the JAX
reference's Pallas kernel (interpret mode) and jnp oracle, the wrapper's
contract (zero sizes, input checks, routing, launch counts), and — on a
machine with an NVIDIA GPU — the CUDA kernel against its plain version.

Inputs come from numpy with a fixed seed and go to both packages.
Tolerances are those of ``tests/test_kernels.py``: f32 atol and rtol 2e-5
(the sums run in other orders), bf16 atol and rtol 3e-2 (the output is
rounded to bf16 once, after an f32 accumulation, by either side).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

# b, sq, sk, h, kh, hd, causal: five of the reference's kernel-test shapes
# (MQA, Sk > Sq non-causal, Sq > Sk, a KV tail that is not a block
# multiple) and a ragged Sq
CASES = [
    (2, 256, 256, 4, 2, 64, True),
    (1, 256, 256, 8, 1, 128, True),
    (2, 128, 384, 4, 4, 64, False),
    (1, 384, 256, 2, 2, 128, True),
    (1, 128, 320, 4, 2, 64, True),
    (1, 100, 100, 2, 2, 64, True),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _inputs(b, sq, sk, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed + sq * 7 + sk * 13 + h + hd)
    return [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))
    ]


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().cpu().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal", CASES)
def test_plain_matches_pallas_and_reference(b, sq, sk, h, kh, hd, causal, dtype):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(b, sq, sk, h, kh, hd)
    got = fa.flash_attention_plain(
        *[torch.from_numpy(a).to(tdt) for a in arrays], causal=causal)
    assert got.shape == (b, sq, h, hd) and got.dtype == tdt
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    kernel = ops.flash_attention(*jargs, causal=causal, interpret=True)
    oracle = ref.flash_attention_reference(*jargs, causal=causal)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_plain_takes_sm_scale():
    arrays = _inputs(1, 64, 64, 2, 1, 32)
    got = fa.flash_attention_plain(*map(torch.from_numpy, arrays), sm_scale=0.3)
    want = ref.flash_attention_reference(*map(jnp.asarray, arrays), sm_scale=0.3)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    q, k, v = map(torch.from_numpy, _inputs(1, 100, 100, 4, 2, 16))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True))
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("shapes", [
    ((1, 0, 2, 16), (1, 8, 2, 16)),
    ((1, 8, 2, 16), (1, 0, 2, 16)),
    ((0, 8, 2, 16), (0, 8, 1, 16)),
    ((1, 8, 2, 16), (1, 8, 0, 16)),
])
def test_zero_size_short_circuits_to_zeros(shapes):
    qs, ks = shapes
    q = torch.ones(qs, dtype=torch.bfloat16)
    k = torch.ones(ks, dtype=torch.bfloat16)
    out = fa.flash_attention(q, k, k.clone())
    assert out.shape == qs and out.dtype == torch.bfloat16
    assert not out.any()
    assert fa.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("q_shape,k_shape,dtype,match", [
    ((1, 8, 3, 16), (1, 8, 2, 16), torch.float32, "multiple of KV heads"),
    ((1, 8, 2, 24), (1, 8, 2, 24), torch.float32, "head dim"),
    ((1, 8, 2, 512), (1, 8, 2, 512), torch.float32, "head dim"),
    ((1, 8, 2, 16), (1, 8, 2, 16), torch.float16, "dtype"),
    ((1, 8, 2, 16), (2, 8, 2, 16), torch.float32, "q's B and hd"),
    ((8, 2, 16), (8, 2, 16), torch.float32, "4-d"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q_shape, k_shape, dtype, match):
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        fa.flash_attention(q, k, k)


def test_wrapper_rejects_mixed_dtypes():
    q = torch.zeros((1, 8, 2, 16), dtype=torch.float32)
    k = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k, k)


# b, sq, sk, h, kh, hd, causal: the serve path's prefill shape and the
# edge cases the kernel must mask itself
CUDA_CASES = CASES + [
    (1, 1024, 1024, 16, 8, 128, True),
    (1, 64, 64, 4, 2, 16, True),
    (1, 200, 200, 2, 1, 256, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal", CUDA_CASES)
def test_cuda_kernel_matches_plain(b, sq, sk, h, kh, hd, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash attention kernel)")
    tdt, _ = DTYPES[dtype]
    q, k, v = [torch.from_numpy(a).to("cuda", tdt) for a in _inputs(b, sq, sk, h, kh, hd)]
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
