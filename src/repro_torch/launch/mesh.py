"""The card's roofline peaks — the counterpart of the reference's
``launch/mesh.py``, whose TPU v5e constants become one NVIDIA H100's.

The numbers are NVIDIA's data sheet for the H100 SXM part: dense rates
(no structured sparsity) at its full power limit of 700 W. A card set to a
lower limit runs slower under load, so a share of one of these peaks is
stated beside the card's name and power limit (:func:`card`).

The reference's ``make_production_mesh`` and ``make_host_mesh`` build JAX
device meshes for its multi-device launchers. The port has none: one LM
runs on one card, and its only mesh is the sweep's and the learners'
worker processes, ``repro_torch.core.shard.Mesh``. On one card the
roofline's collective term is 0 (``launch/dryrun.py``);
:data:`NVLINK_BW` is the rate it would take across cards.
"""
from __future__ import annotations

import subprocess
from typing import Optional

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
