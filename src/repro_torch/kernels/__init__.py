"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the build that compiles them at first use (``_build.py``).

The reference's ``repro.kernels`` exports three functions of these names;
here each name is the module that holds the wrapper of the same name (e.g.
``event_fuse.event_fuse``), its plain version and its launch counts. No
module is imported with the package."""

__all__ = ["flash_attention", "ssd_scan", "event_fuse"]
