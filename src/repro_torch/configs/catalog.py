"""The full configurations of the reference's architectures whose blocks
the port does not run yet, as numbers only — copied from the reference's
``configs/<arch>.py`` ``full()`` functions.

``configs.arch_config(name)`` reads them (the job-profile workload needs
every architecture's widths and depth, not its model); ``get_arch`` still
refuses these names, naming the ROADMAP item that ports their blocks.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs.base import ArchConfig


def _qwen2_moe_a2p7b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        n_experts=60,
        top_k=4,
        expert_d_ff=1408,
        n_shared_experts=4,
        shared_d_ff=5632,
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
    )


def _grok1_314b() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        n_experts=8,
        top_k=2,
        expert_d_ff=32768,
        n_shared_experts=0,
        shared_d_ff=0,
        fsdp=True,
        optimizer="adafactor",
        source="[hf:xai-org/grok-1; unverified]",
    )


def _internvl2_26b() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        n_image_embeds=256,
        fsdp=False,
        optimizer="adafactor",
        source="[arXiv:2404.16821; hf]",
    )


def _whisper_tiny() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        encoder_layers=4,
        encoder_seq=1500,
        source="[arXiv:2212.04356; unverified]",
    )


CONFIG_ONLY: Dict[str, Callable[[], ArchConfig]] = {
    "qwen2-moe-a2.7b": _qwen2_moe_a2p7b,
    "grok-1-314b": _grok1_314b,
    "internvl2-26b": _internvl2_26b,
    "whisper-tiny": _whisper_tiny,
}
