"""The card's roofline peaks — the counterpart of the reference's
``launch/mesh.py``, whose TPU v5e constants become one NVIDIA H100's.

The numbers are NVIDIA's data sheet for the H100 SXM part: dense rates
(no structured sparsity) at its full power limit of 700 W. A card set to a
lower limit runs slower under load, so a share of one of these peaks is
stated beside the card's name and power limit (:func:`card`).

The reference's ``make_production_mesh`` and ``make_host_mesh`` build JAX
device meshes for its multi-device launchers. Here a mesh's shape is an
ordered mapping of axis name to size (:func:`make_production_mesh`, which
the dry run's ``--mesh`` reads for per-card bytes), and the mesh that runs
is ``repro_torch.core.shard.Mesh``'s worker processes, one a rank
(:func:`make_host_mesh`, the tensor-parallel grid of
``training/tensor_parallel.py``). The dry run's roofline keeps its
collective term at 0 (``launch/dryrun.py``); :data:`NVLINK_BW` is the rate
it would take across cards.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional, Tuple

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 (and fp16) on the tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12  # B/s, device memory
HBM_BYTES = 80e9  # bytes of device memory
NVLINK_BW = 900e9  # B/s a card, NVLink 4 (the collective term across cards)

# the peak the roofline's compute term takes for a cell's dtype
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def card() -> Optional[str]:
    """The running card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line), or None where no card answers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh shape: ``{"data": 16, "model":
    16}``, or ``{"pod": 2, "data": 16, "model": 16}``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def parse_mesh(text: str) -> Dict[str, int]:
    """``"DxM"`` or ``"PxDxM"`` as a mesh shape; ``"1"`` is one card, and
    the reference's ``"single"`` and ``"multi"`` its production meshes."""
    if text in ("single", "multi"):
        return make_production_mesh(multi_pod=text == "multi")
    sizes = [int(x) for x in text.lower().split("x")]
    if len(sizes) == 1 and sizes[0] == 1:
        return {"data": 1, "model": 1}
    if len(sizes) == 2:
        return {"data": sizes[0], "model": sizes[1]}
    if len(sizes) == 3:
        return {"pod": sizes[0], "data": sizes[1], "model": sizes[2]}
    raise ValueError(f"a mesh is DxM or PxDxM, got {text!r}")


def make_host_mesh(model_parallel: int = 1, devices: Optional[int] = None, device=None,
                   axis_names: Tuple[str, str] = ("data", "model")):
    """The ``("data", "model")`` grid of worker ranks over ``devices`` ranks
    (the visible cards on CUDA, or ``shard.pinned_cards``' list; on the CPU
    ``model_parallel``): ``{"data": devices // model_parallel, "model":
    model_parallel}`` under ``axis_names``, worker ``d * M + m`` at (d, m)
    — the reference's ``make_host_mesh``. ``device``: cuda unless the
    caller passes ``"cpu"``."""
    from repro_torch.core import shard
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if devices is None:
        devices = shard.visible_cards() if dev.type == "cuda" else model_parallel
    if model_parallel < 1 or devices < 1 or devices % model_parallel:
        raise ValueError(f"{devices} devices do not split into model_parallel="
                         f"{model_parallel} groups")
    if dev.type == "cuda" and devices > shard.visible_cards():
        raise ValueError(f"devices={devices} exceeds the {shard.visible_cards()} "
                         "visible device(s)")
    data, model = axis_names
    return shard.mesh(devices, dev, {data: devices // model_parallel, model: model_parallel})
