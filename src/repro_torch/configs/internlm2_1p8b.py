"""internlm2-1.8b [dense] — GQA kv=8 [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        source="[arXiv:2403.17297; hf]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
