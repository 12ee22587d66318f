"""A CUDA tensor that autograd would record never reaches a hand-written
kernel: ``flash_attention`` and ``ssd_scan`` compute forwards only, so on
the card their wrappers raise when grad mode is on and an input requires
grad, and the train step takes the plain routes. On the CPU the wrappers
take their differentiable plain versions. This file imports no JAX, so it
also runs on a machine with the card (``-m cuda``).
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd


def _attn_inputs(device="cpu", grad=True):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 16, 2, 16), generator=g) for _ in range(3))
    return [x.to(device).requires_grad_(grad) for x in (q, k, v)]


def _scan_inputs(device="cpu", grad=True):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 16, 2, 8), generator=g) for _ in range(3))
    decay = -torch.rand((1, 16, 2), generator=g)
    return [x.to(device).requires_grad_(grad) for x in (q, k, v, decay)]


def test_refuse_grad_names_the_kernel_and_the_plain_routes():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel has no backward.*"
                                           "attn_impl='naive', gla_impl='plain'"):
        _build.refuse_grad("flash_attention", None, x)
    with torch.no_grad():
        _build.refuse_grad("flash_attention", x)  # nothing is recorded: no refusal
    _build.refuse_grad("ssd_scan", torch.zeros(2), None)


def test_cpu_wrappers_take_the_differentiable_plain_versions():
    q, k, v = _attn_inputs()
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (q, k, v))
    q, k, v, g = _scan_inputs()
    y, h = ssd.ssd_scan(q, k, v, g, chunk=8)
    (y.sum() + h.sum()).backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in (q, k, v, g))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_require_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA flash attention and ssd_scan kernels)")
    flash0, ssd0 = fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"]
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel has no backward"):
        fa.flash_attention(*_attn_inputs("cuda"), causal=True)
    with pytest.raises(RuntimeError, match="ssd_scan: the CUDA kernel has no backward"):
        ssd.ssd_scan(*_scan_inputs("cuda"), chunk=8)
    assert (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"]) == (flash0, ssd0)
    with torch.no_grad():  # the same inputs launch when autograd does not record
        fa.flash_attention(*_attn_inputs("cuda"), causal=True)
        ssd.ssd_scan(*_scan_inputs("cuda"), chunk=8)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_attention"], ssd.LAUNCHES["ssd_scan"]) == (flash0 + 1, ssd0 + 1)
