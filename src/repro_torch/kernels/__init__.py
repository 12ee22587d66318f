"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the build that compiles them at first use (``_build.py``)."""
