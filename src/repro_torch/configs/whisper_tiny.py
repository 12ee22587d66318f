"""whisper-tiny [audio] — enc-dec, conv frontend stub [arXiv:2212.04356;
unverified]. The conv/mel frontend is a stub: the model takes 1500
precomputed frame embeddings; encoder (4L, bidirectional) and decoder (4L,
causal + cross-attention) are fully modeled. Decoder self-attention uses
RoPE, as the reference's does (whisper's learned positional embeddings cap
at 448 positions, too few for the reference's 32k decode shapes)."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
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


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        encoder_layers=2,
        encoder_seq=30,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
