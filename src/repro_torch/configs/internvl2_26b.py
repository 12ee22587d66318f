"""internvl2-26b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].
The ViT frontend is a stub: the model takes 256 precomputed patch
embeddings in place of the first token embeddings; the transformer
backbone (InternLM2-20B-class) is fully modeled."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
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
        # fsdp=False + adafactor: the reference's training layout (tensor
        # parallel with a factored optimizer); the port serves inference only
        fsdp=False,
        optimizer="adafactor",
        source="[arXiv:2404.16821; hf]",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        n_image_embeds=8,
        dtype_name="float32",
    )


CONFIG = register(full, reduced)
