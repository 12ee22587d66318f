"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks
[arXiv:2405.04517; unverified]. d_ff=0: the recurrent blocks carry their own
up/down projections (no separate FFN)."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm_expand=2,
        sub_quadratic=True,
        source="[arXiv:2405.04517; unverified]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        ssm_expand=2,
        sub_quadratic=True,
        dtype_name="float32",
        gla_chunk=16,
    )


CONFIG = register(full, reduced)
