"""SPARS simulator on PyTorch and CUDA.

The port of the JAX reference package ``repro`` to PyTorch, with the
reference's TPU kernels rewritten by hand for NVIDIA Hopper. Module names
mirror the reference (``core/engine.py``, ``core/policy.py``, ...) so each
counterpart is easy to find. The package imports torch and numpy only —
never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); see :func:`repro_torch.device.resolve_device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
