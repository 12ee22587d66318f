"""SPARS simulator on PyTorch and CUDA.

The port of the JAX reference package ``repro`` to PyTorch, with the
reference's TPU kernels rewritten by hand for NVIDIA Hopper: the simulator
(``core/``, ``workloads/``, ``launch/sim.py``), its RL stack (``core/rl/``,
``training/``) and the LM serve paths of
``internlm2-1.8b`` and ``xlstm-350m`` (``configs/``, ``models/``,
``launch/serve.py``). Module names mirror the
reference (``core/engine.py``, ``models/transformer.py``, ...) so each
counterpart is easy to find. The package imports torch and numpy only —
never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); see :func:`repro_torch.device.resolve_device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
