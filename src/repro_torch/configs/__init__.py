"""Architecture configs.

``get_arch(name)`` returns the full config; ``get_arch(name, reduced=True)``
the CPU-sized reduction of the same family.
"""
from repro_torch.configs.base import ARCH_REGISTRY, ArchConfig, get_arch, list_archs

__all__ = ["ArchConfig", "ARCH_REGISTRY", "get_arch", "list_archs"]
