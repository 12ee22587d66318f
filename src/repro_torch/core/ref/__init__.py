"""The sequential Python oracle (a copy of the reference's ``core/ref``)."""
from repro_torch.core.ref.pydes import PyDES, run_pydes

__all__ = ["PyDES", "run_pydes"]
