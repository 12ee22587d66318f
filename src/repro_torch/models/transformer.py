"""The LM stack as ``nn.Module``s: the dense and the xLSTM block programs.

Two block types of the reference's block-programmed stack
(``models/transformer.py``):

* ``dense`` — attention (GQA, RoPE) and a SwiGLU MLP, each behind an RMS
  norm, with residuals (``internlm2-1.8b``);
* ``xlstm_pair`` — an mLSTM block then an sLSTM block, each ``x +
  mixer(norm(x))`` (``xlstm-350m``).

The reference stacks each stage's per-layer params on a leading axis for
``lax.scan``; here a :class:`Transformer` holds an ``nn.ModuleList`` of
blocks, and ``models/convert.py`` slices the reference's stacked arrays into
it. A model runs one stage (one block type), as every architecture the port
registers does.

Three execution paths, as in the reference's ``Model``: :meth:`forward`
(no cache), :meth:`prefill` (builds the cache, returns the last position's
logits) and :meth:`decode_step` (one token per sequence). The cache is the
reference's stacked stage cache, one tensor per field with the layer axis
first, preallocated and written in place, which stands in for the
reference's buffer donation: a :class:`KVCache` ``[L, B, S_max, KH, hd]``
for ``dense``, an :class:`XLstmCache` of recurrent states for
``xlstm_pair``. The port runs inference only: parameters do not require
gradients (training is ROADMAP Queue 1 item 12c).

Every other block type, and a program that mixes block types, raises
``NotImplementedError`` naming ROADMAP Queue 1 item 12c.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, KH, hd]
    v: torch.Tensor  # [L, B, S_max, KH, hd]


class XLstmCache(NamedTuple):
    """The recurrent state of each ``xlstm_pair`` (P pairs), f32."""
    mlstm_h: torch.Tensor  # [P, B, H, hd, hd]
    mlstm_n: torch.Tensor  # [P, B, H, hd, 1]
    slstm_c: torch.Tensor  # [P, B, di]
    slstm_n: torch.Tensor  # [P, B, di]
    slstm_m: torch.Tensor  # [P, B, di]
    slstm_h: torch.Tensor  # [P, B, di]


Cache = Union[KVCache, XLstmCache]


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

    def forward(self, x, positions, cache=None,
                cache_pos: Union[int, torch.Tensor, L.RowOffsets] = 0,
                attn_impl: str = "auto") -> torch.Tensor:
        h = self.attn(L.rms_norm(x, self.ln1, self.eps), positions, causal=True,
                      cache=cache, cache_pos=cache_pos, attn_impl=attn_impl)
        x = x + h
        return x + self.mlp(L.rms_norm(x, self.ln2, self.eps))


class XLstmPair(nn.Module):
    """``x + mlstm(norm(x))``, then ``x + slstm(norm(x))`` (the reference's
    ``mlstm``, ``slstm`` and ``xlstm_pair`` branches of ``block_apply``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps, self.chunk = cfg.norm_eps, cfg.gla_chunk
        self.mlstm_ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.mlstm = S.MLstm(S.MLstmDims.make(cfg.d_model, cfg.n_heads, cfg.ssm_expand),
                             cfg.dtype)
        self.slstm_ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.slstm = S.SLstm(S.SLstmDims.make(cfg.d_model, cfg.n_heads), cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``block_init`` for ``xlstm_pair``."""
        self.mlstm_ln.fill_(1.0)
        self.mlstm.init(generator)
        self.slstm_ln.fill_(1.0)
        self.slstm.init(generator)

    def forward(self, x, cache=None, gla_impl: str = "auto") -> torch.Tensor:
        """``cache``: this pair's six :class:`XLstmCache` slices, read as the
        state and overwritten with the new one; None runs from zeros.
        A one-token ``x`` with a cache takes the recurrent decode step."""
        eps = self.eps
        decode = cache is not None and x.shape[1] == 1
        m_state = None if cache is None else cache[:2]
        s_state = None if cache is None else S.SLstmState(*cache[2:])
        inner = L.rms_norm(x, self.mlstm_ln, eps)
        if decode:
            y, m_new = self.mlstm.decode(inner[:, 0], m_state, eps)
            y = y[:, None]
        else:
            y, m_new = self.mlstm(inner, m_state, self.chunk, eps, gla_impl)
        x = x + y
        inner = L.rms_norm(x, self.slstm_ln, eps)
        if decode:
            y, s_new = self.slstm.decode(inner[:, 0], s_state, eps)
            y = y[:, None]
        else:
            y, s_new = self.slstm(inner, s_state, eps)
        if cache is not None:
            for dst, src in zip(cache, (*m_new, *s_new)):
                dst.copy_(src)
        return x + y


_BLOCKS = {"dense": DenseBlock, "xlstm_pair": XLstmPair}


class Transformer(nn.Module):
    """The LM: embedding, the stage's blocks (:class:`DenseBlock` or
    :class:`XLstmPair`), final norm and LM head over the padded vocabulary.
    ``attn_impl`` selects the attention route (see
    :mod:`repro_torch.models.layers`), ``gla_impl`` the GLA route (see
    :mod:`repro_torch.models.ssm`)."""

    def __init__(self, cfg: ArchConfig, attn_impl: str = "auto", gla_impl: str = "auto"):
        super().__init__()
        program = cfg.block_program()
        for btype, _ in program:
            if btype not in _BLOCKS:
                raise NotImplementedError(
                    f"block type {btype!r} is not ported to PyTorch yet "
                    "(ROADMAP Queue 1 item 12c)"
                )
        if len({btype for btype, _ in program}) != 1:
            raise NotImplementedError(
                f"a program of mixed block types {program} is not ported to PyTorch "
                "yet (ROADMAP Queue 1 item 12c)"
            )
        if cfg.n_image_embeds or cfg.encoder_layers or cfg.qk_norm:
            raise NotImplementedError(
                "image and encoder front ends and qk-norm are not ported to "
                "PyTorch yet (ROADMAP Queue 1 item 12c)"
            )
        if attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {L.ATTN_IMPLS}, got {attn_impl!r}")
        if gla_impl not in S.GLA_IMPLS:
            raise ValueError(f"gla_impl must be one of {S.GLA_IMPLS}, got {gla_impl!r}")
        self.config = cfg
        self.block_type = program[0][0]
        self.attn_impl = attn_impl
        self.gla_impl = gla_impl
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Embedding(vp, d, dtype=cfg.dtype)
        n_blocks = sum(count for _, count in program)
        self.blocks = nn.ModuleList(_BLOCKS[self.block_type](cfg) for _ in range(n_blocks))
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

    def _run(self, x, positions, cache: Optional[Cache] = None,
             cache_pos: Union[int, torch.Tensor, L.RowOffsets] = 0):
        for i, block in enumerate(self.blocks):
            layer_cache = None if cache is None else tuple(f[i] for f in cache)
            if self.block_type == "dense":
                x = block(x, positions, layer_cache, cache_pos, self.attn_impl)
            else:
                x = block(x, layer_cache, self.gla_impl)
        return x

    # ---------------- paths ----------------
    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens ``[B, S]`` -> (logits ``[B, S, V]`` f32, aux loss 0)."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        x = self._run(x, positions)
        return self._logits(x), torch.zeros((), device=x.device)

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        """Zeros (the sLSTM's ``m`` at -10, the reference's zero state);
        ``cache_len`` sizes the KV cache and is not read by recurrent blocks."""
        cfg, dev, n = self.config, self.device, len(self.blocks)
        if self.block_type == "dense":
            shape = (n, batch_size, cache_len, cfg.n_kv_heads, cfg.hd)
            return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                           torch.zeros(shape, dtype=cfg.dtype, device=dev))
        hs, ns = S.mlstm_state_shape(self.blocks[0].mlstm.dims, batch_size)
        di = self.blocks[0].slstm.dims.d_inner

        def zeros(*shape):
            return torch.zeros((n, *shape), dtype=torch.float32, device=dev)

        return XLstmCache(zeros(*hs), zeros(*ns), zeros(batch_size, di),
                          zeros(batch_size, di), zeros(batch_size, di) - 10.0,
                          zeros(batch_size, di))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None):
        """tokens ``[B, S]`` -> (last-position logits ``[B, 1, V]`` f32, a
        new cache holding the prompt: ``cache_len`` (default S) positions of
        keys and values, or the recurrent state after the prompt)."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        cache = self.init_cache(b, cache_len or s)
        x = self._run(x, torch.arange(s, device=x.device), cache, 0)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache,
                    pos: Union[int, torch.Tensor]):
        """tokens ``[B, 1]`` at position ``pos`` (the KV cache's write
        offset) -> (logits ``[B, 1, V]`` f32, the same cache, written in
        place). ``pos`` is the batch's one position (an int) or each
        sequence's own (a ``[B]`` int64 tensor on the model's device), which
        RoPE, the cache write and the attention mask then read per row."""
        x = self._embed(tokens)
        if torch.is_tensor(pos):
            positions = pos[:, None]
            if self.block_type == "dense":  # every layer's indices and mask
                pos = L.row_offsets(pos, 1, cache[0].shape[2])
        else:
            positions = torch.arange(pos, pos + 1, device=x.device)
            pos = int(pos)
        x = self._run(x, positions, cache, pos)
        return self._logits(x), cache

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def build_model(cfg: ArchConfig, device: DeviceLike = None, attn_impl: str = "auto",
                gla_impl: str = "auto") -> Transformer:
    """The model on ``device`` (cuda unless asked for cpu), its parameters
    allocated but not filled: call :meth:`Transformer.init` or load the
    reference's arrays with ``convert.params_from_arrays``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg, attn_impl, gla_impl)
    return model.to_empty(device=dev).requires_grad_(False)
