"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. expert d_ff=1408; shared-expert hidden
= 4 x 1408 = 5632."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
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


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        top_k=2,
        expert_d_ff=32,
        n_shared_experts=2,
        shared_d_ff=64,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
