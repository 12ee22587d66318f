"""The dense LM stack as ``nn.Module``s.

The ``dense`` block type of the reference's block-programmed stack
(``models/transformer.py``): attention (GQA, RoPE) and a
SwiGLU MLP, each behind an RMS norm, with residuals. The reference stacks
each stage's per-layer params on a leading axis for ``lax.scan``; here a
:class:`Transformer` holds an ``nn.ModuleList`` of :class:`DenseBlock`\\ s,
and ``models/convert.py`` slices the reference's stacked arrays into it.

Three execution paths, as in the reference's ``Model``: :meth:`forward`
(no cache), :meth:`prefill` (builds the cache, returns the last position's
logits) and :meth:`decode_step` (one token per sequence). The KV cache is a
:class:`KVCache` of two tensors ``[L, B, S_max, KH, hd]`` — the reference's
stacked stage cache — preallocated and written in place, which stands in for
the reference's buffer donation. The port runs inference only: parameters
do not require gradients (training is ROADMAP Queue 1 item 12c).

Every block type other than ``dense`` raises ``NotImplementedError`` naming
its ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

# the ROADMAP item that ports each block type the port does not run yet
_NOT_PORTED = {
    "mlstm": "ROADMAP Queue 1 item 12b",
    "slstm": "ROADMAP Queue 1 item 12b",
    "xlstm_pair": "ROADMAP Queue 1 item 12b",
    "moe": "ROADMAP Queue 1 item 12c",
    "mamba2": "ROADMAP Queue 1 item 12c",
    "zamba_super": "ROADMAP Queue 1 item 12c",
    "enc": "ROADMAP Queue 1 item 12c",
    "dec": "ROADMAP Queue 1 item 12c",
}


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, KH, hd]
    v: torch.Tensor  # [L, B, S_max, KH, hd]


class DenseBlock(nn.Module):
    """``x + attn(norm(x))``, then ``x + swiglu(norm(x))``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                cfg.dtype, theta=cfg.rope_theta)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``block_init`` for ``dense``."""
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions, cache=None, cache_pos: int = 0,
                attn_impl: str = "auto") -> torch.Tensor:
        h = self.attn(L.rms_norm(x, self.ln1, self.eps), positions, causal=True,
                      cache=cache, cache_pos=cache_pos, attn_impl=attn_impl)
        x = x + h
        return x + self.mlp(L.rms_norm(x, self.ln2, self.eps))


class Transformer(nn.Module):
    """The dense LM: embedding, ``n_layers`` :class:`DenseBlock`\\ s, final
    norm and LM head over the padded vocabulary. ``attn_impl`` selects the
    attention route (see :mod:`repro_torch.models.layers`)."""

    def __init__(self, cfg: ArchConfig, attn_impl: str = "auto"):
        super().__init__()
        for btype, _ in cfg.block_program():
            if btype != "dense":
                where = _NOT_PORTED.get(btype, "ROADMAP Queue 1 item 12c")
                raise NotImplementedError(
                    f"block type {btype!r} is not ported to PyTorch yet ({where})"
                )
        if cfg.n_image_embeds or cfg.encoder_layers or cfg.qk_norm:
            raise NotImplementedError(
                "image and encoder front ends and qk-norm are not ported to "
                "PyTorch yet (ROADMAP Queue 1 item 12c)"
            )
        if attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {L.ATTN_IMPLS}, got {attn_impl!r}")
        self.config = cfg
        self.attn_impl = attn_impl
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Embedding(vp, d, dtype=cfg.dtype)
        n_layers = sum(count for _, count in cfg.block_program())
        self.blocks = nn.ModuleList(DenseBlock(cfg) for _ in range(n_layers))
        self.final_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.lm_head = nn.Linear(d, vp, bias=False, dtype=cfg.dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Fill every parameter from ``generator`` (on the model's device):
        the reference's ``init`` distributions, drawn in its order (embed,
        LM head, then each layer). The numbers differ from the reference's
        ``jax.random`` draws; ``convert.params_from_arrays`` carries the
        reference's own parameters across."""
        cfg = self.config
        self.embed.weight.copy_(L.embed_init(generator, cfg.padded_vocab, cfg.d_model, cfg.dtype))
        self.final_norm.fill_(1.0)
        head = L.dense_init(generator, cfg.d_model, cfg.padded_vocab, cfg.dtype)
        self.lm_head.weight.copy_(head.t())
        for block in self.blocks:
            block.init(generator)
        return self

    # ---------------- shared machinery ----------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens.clamp(0, self.config.padded_vocab - 1))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.config.norm_eps)
        return self.lm_head(x).float()

    def _run(self, x, positions, cache: Optional[KVCache] = None, cache_pos: int = 0):
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else (cache.k[i], cache.v[i])
            x = block(x, positions, layer_cache, cache_pos, self.attn_impl)
        return x

    # ---------------- paths ----------------
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens ``[B, S]`` -> (logits ``[B, S, V]`` f32, aux loss 0)."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._run(x, positions)
        return self._logits(x), torch.zeros((), device=x.device)

    def init_cache(self, batch_size: int, cache_len: int) -> KVCache:
        cfg = self.config
        shape = (len(self.blocks), batch_size, cache_len, cfg.n_kv_heads, cfg.hd)
        return KVCache(
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            torch.zeros(shape, dtype=cfg.dtype, device=self.device),
        )

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None):
        """tokens ``[B, S]`` -> (last-position logits ``[B, 1, V]`` f32, a
        new cache of ``cache_len`` (default S) positions holding the prompt)."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        cache = self.init_cache(b, cache_len or s)
        x = self._run(x, torch.arange(s, device=x.device), cache, 0)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: KVCache, pos: int):
        """tokens ``[B, 1]`` at position ``pos`` (the cache write offset) ->
        (logits ``[B, 1, V]`` f32, the same cache, written in place)."""
        x = self._embed(tokens)
        positions = torch.arange(pos, pos + 1, device=x.device)
        x = self._run(x, positions, cache, int(pos))
        return self._logits(x), cache

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                attn_impl: str = "auto") -> Transformer:
    """The model on ``device`` (cuda unless asked for cpu), its parameters
    allocated but not filled: call :meth:`Transformer.init` or load the
    reference's arrays with ``convert.params_from_arrays``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg, attn_impl)
    return model.to_empty(device=dev).requires_grad_(False)
