"""ArchConfig dataclass and the architecture registry.

A copy of the reference's ``configs/base.py`` (the port imports nothing of
``repro``) with ``dtype`` returning a torch dtype. Every architecture the
reference registers is registered here, with the same numbers.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

import torch

BlockSpec = Tuple[str, int]  # (block_type, count)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype_name: str = "bfloat16"
    stages: Tuple[BlockSpec, ...] = ()
    # moe
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    mamba_per_super: int = 6
    # enc-dec / modality-frontend stubs
    encoder_layers: int = 0
    encoder_seq: int = 0
    n_image_embeds: int = 0
    # runtime / distribution (read by the reference's training and sharding)
    sub_quadratic: bool = False
    fsdp: bool = False
    sharding_mode: str = "tp"
    batch_axes: Tuple[str, ...] = ()
    optimizer: str = "adamw"
    remat: bool = True
    remat_policy: str = "full"
    gla_chunk: int = 128
    attn_chunk: int = 1024
    vocab_pad_to: int = 256
    source: str = ""  # provenance note ([source; verified-tier])

    # ---- derived ----
    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype_name]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    def block_program(self) -> Tuple[BlockSpec, ...]:
        """Decoder stage list; default derived from family when not given."""
        if self.stages:
            return self.stages
        if self.family == "moe":
            return (("moe", self.n_layers),)
        if self.family == "hybrid":
            n_super = self.n_layers // self.mamba_per_super
            return (("zamba_super", n_super),)
        if self.family == "ssm":
            return (("xlstm_pair", self.n_layers // 2),)
        if self.family == "audio":
            return (("dec", self.n_layers),)
        return (("dense", self.n_layers),)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ARCH_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
REDUCED_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}

_ARCH_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def register(full: Callable[[], ArchConfig], reduced: Callable[[], ArchConfig]):
    cfg = full()
    ARCH_REGISTRY[cfg.name] = full
    REDUCED_REGISTRY[cfg.name] = reduced
    return cfg


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        if name in _ARCH_MODULES:
            importlib.import_module(_ARCH_MODULES[name])
        else:
            raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return (REDUCED_REGISTRY if reduced else ARCH_REGISTRY)[name]()


def list_archs():
    return sorted(_ARCH_MODULES)
