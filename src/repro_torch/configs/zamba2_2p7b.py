"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks
[arXiv:2411.15242; hf]. 54 Mamba-2 layers grouped into 9 super-blocks of 6,
each followed by one application of a weight-tied shared attention block."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        mamba_per_super=6,
        sub_quadratic=True,
        source="[arXiv:2411.15242; hf]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        mamba_per_super=2,
        sub_quadratic=True,
        dtype_name="float32",
        gla_chunk=16,
    )


CONFIG = register(full, reduced)
