"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].
bf16 weights alone are 628 GB: more than one 80 GB card holds, so the port
runs the reduced config (the reference trains the full one with FSDP and
Adafactor)."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
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


def reduced() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        expert_d_ff=128,
        n_shared_experts=0,
        shared_d_ff=0,
        optimizer="adafactor",
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
