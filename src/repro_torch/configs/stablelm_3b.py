"""stablelm-3b [dense] [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
