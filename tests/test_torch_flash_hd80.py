"""Flash attention at head dim 80 (stablelm-3b, zamba2-2.7b's shared
attention): the wrapper's table sends bf16 to the wgmma kernel and f32 to
the SIMT kernel, the plain version agrees with the JAX package's Pallas
kernel (interpret mode on the CPU) and its reference, and — on a machine
with an NVIDIA GPU — both kernels agree with the plain version.

Inputs come from numpy with a fixed seed, made once for the module, and go
to both packages. bf16 tolerance: atol and rtol 3e-2, as
``tests/test_kernels.py`` (the output is rounded to bf16 once, after an f32
accumulation; the wgmma kernel also rounds the probabilities to bf16 before
P·V). The JAX package is imported inside the tests that use it, so the
``cuda`` tests run where jax is not installed.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

HD = 80
TOL = dict(atol=3e-2, rtol=3e-2)

# b, sq, sk, h, kh, hd, causal: GQA 4:2, MQA 4:1, a ragged Sq against a KV
# tail that is not a multiple of 64, Sq > Sk, one query row against 300
# non-causal keys
CASES = [
    (1, 128, 128, 4, 2, HD, True),
    (1, 96, 96, 4, 1, HD, True),
    (1, 65, 70, 2, 1, HD, True),
    (1, 160, 96, 2, 2, HD, True),
    (1, 1, 300, 2, 2, HD, False),
]
# the stablelm-3b prefill of a 1024-token prompt
FULL = (1, 1024, 1024, 32, 32, HD, True)


@functools.lru_cache(maxsize=None)
def _inputs(b, sq, sk, h, kh, hd):
    rng = np.random.default_rng(80 + 3 * sq + 5 * sk + h + kh)
    return tuple(
        rng.normal(size=shape).astype(np.float32)
        for shape in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))
    )


def _np(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _torch(case, device, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(device, dtype) for a in _inputs(*case[:6])]


def test_hd80_routes():
    assert fa.variant(torch.bfloat16, HD) == "wgmma"
    assert fa.variant(torch.float32, HD) == "simt"


@pytest.mark.parametrize("dtype,hd", [(torch.float32, HD), (torch.bfloat16, 96)])
def test_launch_variant_refuses_wgmma_outside_the_table(dtype, hd):
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    with pytest.raises(ValueError, match="wgmma kernel takes bf16 at hd 64, 80 and 128"):
        fa.launch_variant("wgmma", q, q, q)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_and_reference_at_hd80(case):
    import jax.numpy as jnp
    from repro.kernels import ops, ref

    causal = case[6]
    got = fa.flash_attention_plain(*_torch(case, "cpu"), causal=causal)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in _inputs(*case[:6])]
    kernel = ops.flash_attention(*jargs, causal=causal, interpret=True)
    oracle = ref.flash_attention_reference(*jargs, causal=causal)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the flash attention kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FULL] + CASES)
def test_cuda_wgmma_kernel_matches_plain_at_hd80(case):
    _need_cuda()
    q, k, v = _torch(case, "cuda")
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=case[6])
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1,
                           "flash_attention_simt": 0}
    want = fa.flash_attention_plain(q, k, v, causal=case[6])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FULL] + CASES)
def test_cuda_simt_kernel_still_matches_plain_at_hd80(case):
    """The SIMT kernel, named through ``launch_variant``, on the same inputs."""
    _need_cuda()
    q, k, v = _torch(case, "cuda")
    fa.reset_launches()
    got = fa.launch_variant("simt", q, k, v, causal=case[6])
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 0,
                           "flash_attention_simt": 1}
    want = fa.flash_attention_plain(q, k, v, causal=case[6])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
