"""The flash attention wrapper's two kernel variants: the static (dtype, head
dim) table that picks the wgmma kernel or the SIMT kernel, their launch
counters, the plain version against the JAX reference at the shapes the
wgmma kernel serves, and — on a machine with an NVIDIA GPU — each variant
against the plain version.

Inputs come from numpy with a fixed seed and go to both packages. bf16
tolerance: atol and rtol 3e-2, as ``tests/test_kernels.py`` (the output is
rounded to bf16 once, after an f32 accumulation; the wgmma kernel also
rounds the probabilities to bf16 before P·V).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

TOL = dict(atol=3e-2, rtol=3e-2)
COUNTERS = ("flash_attention", "flash_attention_wgmma", "flash_attention_simt")

# b, sq, sk, h, kh, hd, causal: shapes the table sends to the wgmma kernel
# (bf16, hd 64 or 128): GQA, MQA, a q and a KV tile that are not multiples
# of 64, Sq > Sk, one query row against a long non-causal KV
WGMMA_CASES = [
    (1, 128, 128, 4, 2, 128, True),
    (1, 96, 96, 4, 1, 64, True),
    (1, 65, 70, 2, 1, 128, True),
    (1, 160, 96, 2, 2, 64, True),
    (1, 1, 300, 2, 2, 64, False),
    (2, 64, 64, 2, 2, 128, False),
]


def _inputs(b, sq, sk, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed + 3 * sq + 5 * sk + h + hd)
    return [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))
    ]


def _np(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("hd", list(fa.HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_table(dtype, hd):
    """bf16 at hd 64, 80 and 128 takes the wgmma kernel; everything else the SIMT one."""
    want = "wgmma" if dtype == torch.bfloat16 and hd in (64, 80, 128) else "simt"
    assert fa.variant(dtype, hd) == want


def test_the_table_names_only_known_variants():
    assert set(fa.VARIANTS.values()) == {"wgmma"}
    assert set(fa.LAUNCHES) == set(COUNTERS)


def test_reset_launches_zeroes_every_counter():
    for key in COUNTERS:
        fa.LAUNCHES[key] = 3
    fa.reset_launches()
    assert all(fa.LAUNCHES[key] == 0 for key in COUNTERS)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                      (torch.bfloat16, 32), (torch.float32, 128)])
def test_cpu_route_counts_no_variant(dtype, hd):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(1, 70, 70, 4, 2, hd))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True))
    assert all(fa.LAUNCHES[key] == 0 for key in COUNTERS)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (torch.bfloat16, 96)])
def test_launch_variant_refuses_wgmma_outside_the_table(dtype, hd):
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    with pytest.raises(ValueError, match="wgmma kernel takes bf16"):
        fa.launch_variant("wgmma", q, q, q)


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal", WGMMA_CASES)
def test_plain_matches_pallas_and_reference_where_wgmma_serves(b, sq, sk, h, kh, hd, causal):
    arrays = _inputs(b, sq, sk, h, kh, hd)
    assert fa.variant(torch.bfloat16, hd) == "wgmma"
    got = fa.flash_attention_plain(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in arrays], causal=causal)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    kernel = ops.flash_attention(*jargs, causal=causal, interpret=True)
    oracle = ref.flash_attention_reference(*jargs, causal=causal)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


# the serve path's prefill shape and the edge cases above
CUDA_CASES = [(1, 1024, 1024, 16, 8, 128, True)] + WGMMA_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal", CUDA_CASES)
def test_cuda_wgmma_kernel_matches_plain(b, sq, sk, h, kh, hd, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the wgmma flash attention kernel)")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _inputs(b, sq, sk, h, kh, hd))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1,
                           "flash_attention_simt": 0}
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal", CUDA_CASES[:3])
def test_cuda_simt_kernel_on_bf16_matches_plain(b, sq, sk, h, kh, hd, causal):
    """The SIMT kernel, named explicitly, on inputs the table sends to wgmma."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the SIMT flash attention kernel)")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _inputs(b, sq, sk, h, kh, hd))
    fa.reset_launches()
    got = fa.launch_variant("simt", q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_simt"] == 1
    assert fa.LAUNCHES["flash_attention_wgmma"] == 0
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
