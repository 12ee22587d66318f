"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        source="[hf:THUDM/glm-4-9b; hf]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
