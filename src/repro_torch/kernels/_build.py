"""Build the hand-written CUDA kernel at first use.

``csrc/<name>.cu`` has a plain C entry point. It is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch/`` at the root of the checkout (gitignored), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time.

:func:`refuse_grad` is the wrappers' shared guard: the kernels compute
forwards only, so a CUDA input that autograd would record is refused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout (src/../build)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def target(name: str) -> Path:
    """The shared library that the current ``csrc/<name>.cu`` builds to."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """``nvcc``'s ``-Xptxas=-v`` report (registers, shared memory, spills)
    from the build of ``name`` ('' if none)."""
    log = Path(str(target(name)) + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if it is missing; raises
    with the compiler's output if the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = target(name)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # build under a unique name, then rename: a concurrent build of the
        # same source never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {name}:\n{res.stdout}")
        Path(str(path) + ".log").write_text(res.stdout)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _LIBS[name] = lib
    return lib


def refuse_grad(name: str, *xs: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record a kernel's CUDA inputs: the kernels
    have no backward, so their output would carry no gradient."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "train through the plain route (attn_impl='naive', gla_impl='plain'), "
            "or call it under torch.no_grad()"
        )
