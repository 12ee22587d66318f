"""Architecture configs.

``get_arch(name)`` returns the full config; ``get_arch(name, reduced=True)``
the CPU-sized reduction of the same family. ``arch_config(name)`` returns
the full config of any of the reference's architectures, ported or not.
"""
from repro_torch.configs.base import (
    ARCH_REGISTRY,
    ArchConfig,
    arch_config,
    get_arch,
    list_archs,
)

__all__ = ["ArchConfig", "ARCH_REGISTRY", "arch_config", "get_arch", "list_archs"]
