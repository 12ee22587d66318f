"""qwen3-14b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=17408,
        vocab_size=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        head_dim=16,
        qk_norm=True,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
