"""The LM stack as ``nn.Module``s: every block program the reference's
registered architectures use.

The block types of the reference's block-programmed stack
(``models/transformer.py``):

* ``dense`` — attention (GQA, RoPE, optional qk-norm) and a SwiGLU MLP,
  each behind an RMS norm, with residuals (``internlm2-1.8b``, ``glm4-9b``,
  ``stablelm-3b``, ``qwen3-14b``, and ``internvl2-26b``'s backbone);
* ``moe`` — the same attention, then routed top-k experts with per-row
  capacity dropping and optional shared experts (:mod:`.moe`;
  ``qwen2-moe-a2.7b``, ``grok-1-314b``);
* ``zamba_super`` — ``mamba_per_super`` Mamba-2 blocks, each ``x +
  mixer(norm(x))``, then one application of the weight-tied shared
  attention block, a ``dense`` block whose parameters the
  :class:`Transformer` holds once for every super-block (``zamba2-2.7b``);
* ``xlstm_pair`` — an mLSTM block then an sLSTM block, each ``x +
  mixer(norm(x))`` (``xlstm-350m``);
* ``dec`` — causal self-attention with RoPE, cross attention over the
  encoder memory, then a GELU MLP (``whisper-tiny``'s decoder), beside the
  :class:`Encoder`, a stack of ``enc`` blocks (unmasked attention without
  RoPE, then a GELU MLP) over frame embeddings plus sinusoidal positions;
* ``mamba2``, ``mlstm``, ``slstm`` — one recurrent mixer, ``x +
  mixer(norm(x))``, as a stage of its own (the halves of ``zamba_super``
  and ``xlstm_pair``), and ``enc`` as a decoder stage: uncached, so a
  decode step's ``enc`` block sees the new token only, as the reference's
  does.

Two front ends: ``image_embeds`` take the place of the first
``n_image_embeds`` token embeddings (``internvl2-26b``; the length is
unchanged), and ``encoder_frames`` go through the encoder, whose output is
the decoder's cross-attention memory (``whisper-tiny``). Both enter at the
forward and prefill; decode embeds tokens only.

An architecture is a block program, ``cfg.block_program()``: stages of
(block type, count), run in order. The reference stacks each stage's
per-layer params on a leading axis for ``lax.scan``; here a
:class:`Transformer` holds its blocks in one ``nn.ModuleList``, stage after
stage (``blocks``; :attr:`Transformer.stages` gives each stage's blocks as
a ``ModuleList`` of one type), and ``models/convert.py`` slices the
reference's stacked arrays into it. Every architecture the reference
registers runs one stage; ``ArchConfig.stages`` may mix them.

Three execution paths, as in the reference's ``Model``: :meth:`forward`
(no cache; it returns the layers' summed MoE aux loss beside the logits),
:meth:`prefill` (builds the cache, returns the last position's logits) and
:meth:`decode_step` (one token per sequence). The cache is the reference's
stacked stage cache, one tensor per field with the layer axis first,
preallocated and written in place, which stands in for the reference's
buffer donation: a :class:`KVCache` ``[L, B, S_max, KH, hd]`` for ``dense``
and ``moe``, a :class:`ZambaCache` (each Mamba-2 layer's state and conv
tails, each shared-attention application's keys and values) for
``zamba_super``, an :class:`XLstmCache` of recurrent states for
``xlstm_pair``, an :class:`EncDecCache` (self and cross keys and values)
for ``dec``, a :class:`Mamba2Cache`, :class:`MLstmCache` or
:class:`SLstmCache` for a standalone recurrent stage and None for ``enc``.
A one-stage program's cache is that stage's; a program of more than one
stage has a tuple of them, parallel to the program, as the reference's
``caches``. :meth:`Transformer.loss` is the reference's training loss over
the forward; the MoE aux loss sums over every stage.

Parameters do not require gradients: inference stays frozen, and
``training/train_step.py`` makes them trainable (``requires_grad_``). With
``cfg.remat``, a forward under autograd runs each block, each Mamba-2
layer and each application of zamba2's shared block, and each encoder
block, through ``torch.utils.checkpoint`` (non-reentrant), as the
reference rematerialises each scanned block: the activations inside are
recomputed in the backward, which changes memory, not numbers. Prefill
and decode run without autograd and are never rematerialised.

An unknown block type raises ``ValueError``, as the reference's
``block_init`` does.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import MoE


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


class ZambaCache(NamedTuple):
    """The state of each ``zamba_super`` (P super-blocks of M Mamba-2 layers,
    layer ``p * M + m`` for the p-th super-block's m-th), layer axis first:
    the Mamba-2 state and conv tails f32, and the keys and values of each
    shared-attention application in the model dtype."""
    mamba_h: torch.Tensor  # [P*M, B, H, N, hd]
    conv_x: torch.Tensor  # [P*M, B, K-1, d_inner]
    conv_bc: torch.Tensor  # [P*M, B, K-1, 2N]
    k: torch.Tensor  # [P, B, S_max, KH, hd]
    v: torch.Tensor  # [P, B, S_max, KH, hd]


class EncDecCache(NamedTuple):
    """Each ``dec`` layer's self-attention keys and values and its cross
    keys and values over the encoder memory, layer axis first."""
    k: torch.Tensor  # [L, B, S_max, KH, hd]
    v: torch.Tensor  # [L, B, S_max, KH, hd]
    cross_k: torch.Tensor  # [L, B, encoder_seq, KH, hd]
    cross_v: torch.Tensor  # [L, B, encoder_seq, KH, hd]


class Mamba2Cache(NamedTuple):
    """A standalone ``mamba2`` stage's state, layer axis first, f32."""
    h: torch.Tensor  # [L, B, H, N, hd]
    conv_x: torch.Tensor  # [L, B, K-1, d_inner]
    conv_bc: torch.Tensor  # [L, B, K-1, 2N]


class MLstmCache(NamedTuple):
    """A standalone ``mlstm`` stage's state, layer axis first, f32."""
    h: torch.Tensor  # [L, B, H, hd, hd]
    n: torch.Tensor  # [L, B, H, hd, 1]


class SLstmCache(NamedTuple):
    """A standalone ``slstm`` stage's state, layer axis first, f32."""
    c: torch.Tensor  # [L, B, di]
    n: torch.Tensor  # [L, B, di]
    m: torch.Tensor  # [L, B, di]
    h: torch.Tensor  # [L, B, di]


StageCache = Union[KVCache, ZambaCache, XLstmCache, EncDecCache, Mamba2Cache, MLstmCache,
                   SLstmCache]
# one stage's cache, or a tuple parallel to a program of more than one (None
# for an ``enc`` stage)
Cache = Union[StageCache, Tuple[Optional[StageCache], ...]]


def _remat(enabled: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward when ``enabled`` and
    autograd records (a training forward)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attention(cfg: ArchConfig, rope: bool = True, qk_norm: Optional[bool] = None
               ) -> L.Attention:
    return L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.dtype,
                       theta=cfg.rope_theta if rope else 0.0,
                       qk_norm=cfg.qk_norm if qk_norm is None else qk_norm,
                       eps=cfg.norm_eps)


def _norm_gain(cfg: ArchConfig) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))


class DenseBlock(nn.Module):
    """``x + attn(norm(x))``, then ``x + swiglu(norm(x))``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm_gain(cfg)
        self.attn = _attention(cfg)
        self.ln2 = _norm_gain(cfg)
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


class MoeBlock(nn.Module):
    """``x + attn(norm(x))`` (the ``dense`` block's attention), then ``x +
    moe(norm(x))``; the forward returns the MoE's aux loss beside x."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm_gain(cfg)
        self.attn = _attention(cfg)
        self.ln2 = _norm_gain(cfg)
        self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.top_k, cfg.expert_d_ff,
                       cfg.n_shared_experts, cfg.shared_d_ff, cfg.capacity_factor, cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's ``block_init`` for ``moe``."""
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init(generator)
        self.moe.init(generator)

    def forward(self, x, positions, cache=None,
                cache_pos: Union[int, torch.Tensor, L.RowOffsets] = 0,
                attn_impl: str = "auto"):
        h = self.attn(L.rms_norm(x, self.ln1, self.eps), positions, causal=True,
                      cache=cache, cache_pos=cache_pos, attn_impl=attn_impl)
        x = x + h
        y, aux = self.moe(L.rms_norm(x, self.ln2, self.eps))
        return x + y, aux


class EncBlock(nn.Module):
    """``x + attn(norm(x))`` unmasked and without RoPE, then ``x +
    gelu_mlp(norm(x))`` (the reference's ``enc`` block)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm_gain(cfg)
        self.attn = _attention(cfg, rope=False)
        self.ln2 = _norm_gain(cfg)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)
        self.attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions, attn_impl: str = "auto") -> torch.Tensor:
        x = x + self.attn(L.rms_norm(x, self.ln1, self.eps), positions, causal=False,
                          attn_impl=attn_impl)
        return x + self.mlp(L.rms_norm(x, self.ln2, self.eps))


class Encoder(nn.Module):
    """The reference's ``encode``: frames plus sinusoidal positions, the
    ``enc`` blocks, then the final norm."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps, self.remat = cfg.norm_eps, cfg.remat
        self.blocks = nn.ModuleList(EncBlock(cfg) for _ in range(cfg.encoder_layers))
        self.final_norm = _norm_gain(cfg)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for block in self.blocks:
            block.init(generator)
        self.final_norm.fill_(1.0)

    def forward(self, frames: torch.Tensor, attn_impl: str = "auto") -> torch.Tensor:
        """frames ``[B, S, D]`` -> the memory ``[B, S, D]`` in the model dtype."""
        dt = self.final_norm.dtype
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = frames.to(dt) + L.sinusoidal(pos, frames.shape[2]).to(dt)[None]
        for block in self.blocks:
            x = _remat(self.remat, block, x, pos, attn_impl)
        return L.rms_norm(x, self.final_norm, self.eps)


class DecBlock(nn.Module):
    """``x + self_attn(norm(x))`` (causal, RoPE, cached), ``x +
    cross_attn(norm(x), memory)``, then ``x + gelu_mlp(norm(x))`` (the
    reference's ``dec`` block; its cross attention has no qk-norm)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1 = _norm_gain(cfg)
        self.self_attn = _attention(cfg)
        self.ln2 = _norm_gain(cfg)
        self.cross_attn = _attention(cfg, rope=False, qk_norm=False)
        self.ln3 = _norm_gain(cfg)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for ln in (self.ln1, self.ln2, self.ln3):
            ln.fill_(1.0)
        self.self_attn.init(generator)
        self.cross_attn.init(generator)
        self.mlp.init(generator)

    def forward(self, x, positions, memory=None, cache=None,
                cache_pos: Union[int, torch.Tensor, L.RowOffsets] = 0,
                attn_impl: str = "auto") -> torch.Tensor:
        """``memory``: the encoder's output, or None to read the cross keys
        and values from ``cache`` (this layer's four :class:`EncDecCache`
        slices), as decode does."""
        x = x + self.self_attn(L.rms_norm(x, self.ln1, self.eps), positions, causal=True,
                               cache=None if cache is None else cache[:2],
                               cache_pos=cache_pos, attn_impl=attn_impl)
        x = x + self.cross_attn.cross(L.rms_norm(x, self.ln2, self.eps), memory,
                                      None if cache is None else cache[2:], attn_impl)
        return x + self.mlp(L.rms_norm(x, self.ln3, self.eps))


def _copy_state(cache, new) -> None:
    """Overwrite a cache's slices (views) with a block's new state."""
    for dst, src in zip(cache, new):
        dst.copy_(src)


def _recurrent(mixer, ln, x, state, eps: float, *scan_args):
    """``x + mixer(norm(x))`` and the mixer's new state (an mLSTM's (h, n),
    an sLSTM's :class:`~.ssm.SLstmState`): the recurrent decode step for a
    one-token ``x`` with a state, else the scan from ``state`` (None:
    zeros), ``mixer(inner, state, *scan_args)``."""
    inner = L.rms_norm(x, ln, eps)
    if state is not None and x.shape[1] == 1:
        y, new = mixer.decode(inner[:, 0], state, eps)
        return x + y[:, None], new
    y, new = mixer(inner, state, *scan_args)
    return x + y, new


def _mlstm_dims(cfg: ArchConfig) -> S.MLstmDims:
    return S.MLstmDims.make(cfg.d_model, cfg.n_heads, cfg.ssm_expand)


def _slstm_dims(cfg: ArchConfig) -> S.SLstmDims:
    return S.SLstmDims.make(cfg.d_model, cfg.n_heads)


class XLstmPair(nn.Module):
    """``x + mlstm(norm(x))``, then ``x + slstm(norm(x))`` (the reference's
    ``mlstm``, ``slstm`` and ``xlstm_pair`` branches of ``block_apply``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps, self.chunk = cfg.norm_eps, cfg.gla_chunk
        self.mlstm_ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.mlstm = S.MLstm(_mlstm_dims(cfg), cfg.dtype)
        self.slstm_ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.dtype))
        self.slstm = S.SLstm(_slstm_dims(cfg), cfg.dtype)

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
        m_state = None if cache is None else cache[:2]
        s_state = None if cache is None else S.SLstmState(*cache[2:])
        x, m_new = _recurrent(self.mlstm, self.mlstm_ln, x, m_state, self.eps,
                              self.chunk, self.eps, gla_impl)
        x, s_new = _recurrent(self.slstm, self.slstm_ln, x, s_state, self.eps, self.eps)
        if cache is not None:
            _copy_state(cache, (*m_new, *s_new))
        return x


class MLstmBlock(nn.Module):
    """``x + mlstm(norm(x))`` (the reference's standalone ``mlstm`` block;
    the first half of :class:`XLstmPair`)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps, self.chunk = cfg.norm_eps, cfg.gla_chunk
        self.ln = _norm_gain(cfg)
        self.mixer = S.MLstm(_mlstm_dims(cfg), cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln.fill_(1.0)
        self.mixer.init(generator)

    def forward(self, x, cache=None, gla_impl: str = "auto") -> torch.Tensor:
        """``cache``: this layer's (h, n) slices of an :class:`MLstmCache`,
        read and overwritten; None runs from zeros."""
        x, new = _recurrent(self.mixer, self.ln, x, cache, self.eps, self.chunk, self.eps,
                            gla_impl)
        if cache is not None:
            _copy_state(cache, new)
        return x


class SLstmBlock(nn.Module):
    """``x + slstm(norm(x))`` (the reference's standalone ``slstm`` block;
    the second half of :class:`XLstmPair`)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln = _norm_gain(cfg)
        self.mixer = S.SLstm(_slstm_dims(cfg), cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln.fill_(1.0)
        self.mixer.init(generator)

    def forward(self, x, cache=None, gla_impl: str = "auto") -> torch.Tensor:
        """``cache``: this layer's (c, n, m, h) slices of an
        :class:`SLstmCache`, read and overwritten; None runs from the zero
        state. ``gla_impl`` is unused (no GLA scan)."""
        x, new = _recurrent(self.mixer, self.ln, x,
                            None if cache is None else S.SLstmState(*cache), self.eps, self.eps)
        if cache is not None:
            _copy_state(cache, new)
        return x


def mamba_dims(cfg: ArchConfig) -> S.Mamba2Dims:
    return S.Mamba2Dims.make(cfg.d_model, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_head_dim)


class Mamba2Block(nn.Module):
    """``x + mamba2(norm(x))`` (the reference's ``mamba2`` block)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.eps, self.chunk = cfg.norm_eps, cfg.gla_chunk
        self.ln = _norm_gain(cfg)
        self.mixer = S.Mamba2(mamba_dims(cfg), cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.ln.fill_(1.0)
        self.mixer.init(generator)

    def forward(self, x, cache=None, gla_impl: str = "auto") -> torch.Tensor:
        """``cache``: this layer's (h, conv_x, conv_bc) slices of a
        :class:`ZambaCache` or :class:`Mamba2Cache`, read as the state and
        overwritten with the new one; None runs from zeros. A one-token
        ``x`` with a cache takes the recurrent decode step."""
        inner = L.rms_norm(x, self.ln, self.eps)
        if cache is None:
            return x + self.mixer(inner, chunk=self.chunk, eps=self.eps, gla_impl=gla_impl)[0]
        h, cx, cbc = cache
        if x.shape[1] == 1:
            y, (h_new, (cx_new, cbc_new)) = self.mixer.decode(inner[:, 0], (h, (cx, cbc)),
                                                              self.eps)
            y = y[:, None]
        else:
            y, (h_new, (cx_new, cbc_new)) = self.mixer(inner, h, (cx, cbc), self.chunk,
                                                       self.eps, gla_impl)
        _copy_state(cache, (h_new, cx_new, cbc_new))
        return x + y


class ZambaSuper(nn.Module):
    """``mamba_per_super`` :class:`Mamba2Block`s, then the shared attention
    block, which the :class:`Transformer` holds and passes in (the
    reference's ``zamba_super`` branch of ``block_apply``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.remat = cfg.remat
        self.mamba = nn.ModuleList(Mamba2Block(cfg) for _ in range(cfg.mamba_per_super))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for block in self.mamba:
            block.init(generator)

    def forward(self, x, positions, shared: DenseBlock, cache=None,
                cache_pos: Union[int, torch.Tensor, L.RowOffsets] = 0,
                attn_impl: str = "auto", gla_impl: str = "auto") -> torch.Tensor:
        """``cache``: this super-block's (h, conv_x, conv_bc) ``[M, ...]`` and
        (k, v) slices of a :class:`ZambaCache`, or None."""
        if cache is None:
            for block in self.mamba:
                x = _remat(self.remat, block, x, None, gla_impl)
            return _remat(self.remat, shared, x, positions, None, 0, attn_impl)
        for m, block in enumerate(self.mamba):
            x = block(x, tuple(f[m] for f in cache[:3]), gla_impl)
        return shared(x, positions, cache[3:], cache_pos, attn_impl)


_BLOCKS = {"dense": DenseBlock, "moe": MoeBlock, "zamba_super": ZambaSuper,
           "xlstm_pair": XLstmPair, "dec": DecBlock, "enc": EncBlock, "mamba2": Mamba2Block,
           "mlstm": MLstmBlock, "slstm": SLstmBlock}
# the stages whose blocks attend over a KV cache (a [B] decode position
# becomes each row's indices and mask over it)
_CACHED_ATTENTION = ("dense", "moe", "dec", "zamba_super")


class Transformer(nn.Module):
    """The LM: embedding, the program's blocks (each of :data:`_BLOCKS`),
    stage after stage, for a ``zamba_super`` stage the shared attention
    block ``shared_attn``, with ``encoder_layers`` the :class:`Encoder`
    ``encoder``, final norm and LM head over the padded vocabulary.
    ``attn_impl`` selects the attention route (see
    :mod:`repro_torch.models.layers`), ``gla_impl`` the GLA route (see
    :mod:`repro_torch.models.ssm`).

    On a tensor-parallel rank (``training/tensor_parallel.py``), ``tp`` is
    the rank's model group and the embedding and LM head hold the rank's
    rows of the padded vocabulary: the embedding is a masked lookup of those
    rows, reduced over the group; the logits are the rank's ``[B, S, Vp /
    M]`` columns, and :meth:`loss` takes the cross entropy over the whole
    vocabulary from them (its max, its sum of exps and the gold logit
    reduced over the group) and counts the targets over the data group."""

    tp = None  # the rank's model group, on a tensor-parallel rank

    def __init__(self, cfg: ArchConfig, attn_impl: str = "auto", gla_impl: str = "auto"):
        super().__init__()
        program = tuple(cfg.block_program())
        for btype, _ in program:
            if btype not in _BLOCKS:
                raise ValueError(f"unknown block type {btype}")
        if attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {L.ATTN_IMPLS}, got {attn_impl!r}")
        if gla_impl not in S.GLA_IMPLS:
            raise ValueError(f"gla_impl must be one of {S.GLA_IMPLS}, got {gla_impl!r}")
        self.config = cfg
        self.program = program
        self.attn_impl = attn_impl
        self.gla_impl = gla_impl
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Embedding(vp, d, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(_BLOCKS[btype](cfg) for btype, count in program
                                    for _ in range(count))
        shared = any(btype == "zamba_super" for btype, _ in program)
        self.shared_attn = DenseBlock(cfg) if shared else None
        self.encoder = Encoder(cfg) if cfg.encoder_layers else None
        self.final_norm = nn.Parameter(torch.ones(d, dtype=cfg.dtype))
        self.lm_head = nn.Linear(d, vp, bias=False, dtype=cfg.dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def stages(self) -> Tuple[Tuple[str, nn.ModuleList], ...]:
        """Each stage of the program: its block type and its blocks, a
        ``ModuleList`` over :attr:`blocks`' slice."""
        out, start = [], 0
        for btype, count in self.program:
            out.append((btype, self.blocks[start:start + count]))
            start += count
        return tuple(out)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Fill every parameter from ``generator`` (on the model's device):
        the reference's ``init`` distributions, drawn in its order (embed,
        LM head, each layer, the shared block, the encoder). The numbers
        differ from the reference's ``jax.random`` draws;
        ``convert.params_from_arrays`` carries the reference's own
        parameters across."""
        cfg = self.config
        self.embed.weight.copy_(L.embed_init(generator, cfg.padded_vocab, cfg.d_model, cfg.dtype))
        self.final_norm.fill_(1.0)
        head = L.dense_init(generator, cfg.d_model, cfg.padded_vocab, cfg.dtype)
        self.lm_head.weight.copy_(head.t())
        for block in self.blocks:
            block.init(generator)
        if self.shared_attn is not None:
            self.shared_attn.init(generator)
        if self.encoder is not None:
            self.encoder.init(generator)
        return self

    # ---------------- shared machinery ----------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.clamp(0, self.config.padded_vocab - 1)
        if self.tp is None:
            return self.embed(tokens)
        rows, inside = self.tp.vocab_rows(tokens)
        x = F.embedding(rows, self.embed.weight) * inside[..., None].to(self.embed.weight.dtype)
        return self.tp.exit(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.config.norm_eps)
        if self.tp is not None:
            x = self.tp.enter(x)
        return self.lm_head(x).float()

    def _embed_inputs(self, tokens: torch.Tensor,
                      image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's ``embed_inputs``: with ``n_image_embeds``, the
        image embeds ``[B, n, D]`` take the place of the first n token
        embeddings."""
        x = self._embed(tokens)
        n = self.config.n_image_embeds
        if n:
            if image_embeds is None:
                raise ValueError(f"{self.config.name} takes image_embeds [B, {n}, D]")
            x = torch.cat([image_embeds.to(x.dtype), x[:, n:]], 1)
        return x

    def _memory(self, encoder_frames: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The encoder's output over ``encoder_frames``, or None without an
        encoder."""
        if self.encoder is None:
            return None
        if encoder_frames is None:
            raise ValueError(f"{self.config.name} takes encoder_frames [B, S, D]")
        return self.encoder(encoder_frames, self.attn_impl)

    def _run(self, x, positions, cache: Optional[Cache] = None,
             cache_pos: Union[int, torch.Tensor] = 0,
             memory: Optional[torch.Tensor] = None):
        """(x after every stage, the sum of the MoE layers' aux losses, a
        f32 scalar). A ``[B]`` ``cache_pos`` becomes each attention stage's
        row indices and mask over its cache, once a stage."""
        aux = torch.zeros((), device=x.device)
        remat = self.config.remat and cache is None
        caches = (None,) * len(self.program) if cache is None else self.stage_caches(cache)
        for (btype, blocks), c in zip(self.stages, caches):
            pos = cache_pos
            if torch.is_tensor(pos) and btype in _CACHED_ATTENTION:
                pos = L.row_offsets(pos, x.shape[1], c.k.shape[2])
            for i, block in enumerate(blocks):
                if btype == "zamba_super":
                    x = block(x, positions, self.shared_attn, self._super_cache(c, i), pos,
                              self.attn_impl, self.gla_impl)
                    continue
                layer_cache = None if c is None else tuple(f[i] for f in c)
                if btype == "dense":
                    x = _remat(remat, block, x, positions, layer_cache, pos, self.attn_impl)
                elif btype == "moe":
                    x, a = _remat(remat, block, x, positions, layer_cache, pos,
                                  self.attn_impl)
                    aux = aux + a
                elif btype == "dec":
                    x = _remat(remat, block, x, positions, memory, layer_cache, pos,
                               self.attn_impl)
                elif btype == "enc":
                    x = _remat(remat, block, x, positions, self.attn_impl)
                else:
                    x = _remat(remat, block, x, layer_cache, self.gla_impl)
        return x, aux

    def stage_caches(self, cache: Cache) -> Tuple[Optional[StageCache], ...]:
        """``cache`` as a tuple parallel to the program: a one-stage
        program's cache is its stage's."""
        return (cache,) if len(self.program) == 1 else tuple(cache)

    def _super_cache(self, cache: Optional[ZambaCache], i: int):
        """Super-block i's slices of a :class:`ZambaCache`: its M Mamba-2
        layers' fields and its shared-attention application's keys and
        values (views, written in place)."""
        if cache is None:
            return None
        m = self.config.mamba_per_super
        return (*(f[i * m:(i + 1) * m] for f in cache[:3]), cache.k[i], cache.v[i])

    # ---------------- paths ----------------
    def forward(self, tokens: torch.Tensor, image_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens ``[B, S]`` (and the arch's front-end input) -> (logits
        ``[B, S, V]`` f32, the layers' summed MoE aux loss, f32; 0 without
        experts)."""
        x = self._embed_inputs(tokens, image_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run(x, positions, memory=self._memory(encoder_frames))
        return self._logits(x), aux

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's training loss over ``batch`` (``tokens`` ``[B,
        S]``, and the arch's ``image_embeds`` or ``encoder_frames``): cross
        entropy of each next token, over targets ``>= 0`` past the first
        ``n_image_embeds`` positions, plus ``moe_aux_weight`` times the MoE
        aux loss. Returns (total, {"ce", "aux", "tokens"}), f32 scalars;
        ``tokens`` is the count of targets, at least 1. On a tensor-parallel
        rank ``tokens`` counts the whole data group's targets, so ``ce`` is
        the rank's share of the global batch's mean."""
        cfg = self.config
        tokens = batch["tokens"]
        logits, aux = self(tokens, batch.get("image_embeds"), batch.get("encoder_frames"))
        targets = tokens[:, 1:]
        lg = logits[:, :-1]
        mask = (targets >= 0).float()
        if cfg.n_image_embeds:
            pos_mask = torch.arange(targets.shape[1], device=mask.device) >= cfg.n_image_embeds
            mask = mask * pos_mask[None, :]
        tgt = targets.clamp(0, cfg.padded_vocab - 1).long()
        if self.tp is None:
            logz = torch.logsumexp(lg, -1)
            gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
            count = mask.sum()
        else:
            logz, gold = self.tp.cross_entropy_terms(lg, tgt)
            count = self.tp.data_sum(mask.sum())
        nll = (logz - gold) * mask
        denom = torch.clamp(count, min=1.0)
        ce = nll.sum() / denom
        total = ce + cfg.moe_aux_weight * aux
        return total, {"ce": ce, "aux": aux, "tokens": denom}

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        """Zeros (the sLSTM's ``m`` at -10, the reference's zero state);
        ``cache_len`` sizes the KV cache and is not read by recurrent blocks;
        a ``dec`` cache's cross keys and values span ``encoder_seq``. One
        stage's cache, or a tuple of them parallel to the program."""
        caches = tuple(self._stage_cache(btype, count, batch_size, cache_len)
                       for btype, count in self.program)
        return caches[0] if len(caches) == 1 else caches

    def _stage_cache(self, btype: str, n: int, batch_size: int, cache_len: int
                     ) -> Optional[StageCache]:
        """The zero cache of a stage of ``n`` blocks of ``btype`` (the
        reference's ``block_cache`` stacked ``n`` times)."""
        cfg, dev = self.config, self.device
        kv_heads = cfg.n_kv_heads if self.tp is None else self.tp.kv_heads
        kv = (n, batch_size, cache_len, kv_heads, cfg.hd)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if btype in ("dense", "moe"):
            return KVCache(zeros(*kv, dtype=cfg.dtype), zeros(*kv, dtype=cfg.dtype))
        if btype == "dec":
            cross = (n, batch_size, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
            return EncDecCache(*(zeros(*shape, dtype=cfg.dtype)
                                 for shape in (kv, kv, cross, cross)))
        if btype in ("zamba_super", "mamba2"):
            hs, (cxs, cbcs) = S.mamba2_state_shape(mamba_dims(cfg), batch_size)
            if btype == "mamba2":
                return Mamba2Cache(*(zeros(n, *shape) for shape in (hs, cxs, cbcs)))
            layers = n * cfg.mamba_per_super
            return ZambaCache(*(zeros(layers, *shape) for shape in (hs, cxs, cbcs)),
                              zeros(*kv, dtype=cfg.dtype), zeros(*kv, dtype=cfg.dtype))
        if btype == "enc":
            return None
        hs, ns = S.mlstm_state_shape(_mlstm_dims(cfg), batch_size)
        di = _slstm_dims(cfg).d_inner
        slstm = (zeros(n, batch_size, di), zeros(n, batch_size, di),
                 zeros(n, batch_size, di) - 10.0, zeros(n, batch_size, di))
        if btype == "mlstm":
            return MLstmCache(zeros(n, *hs), zeros(n, *ns))
        if btype == "slstm":
            return SLstmCache(*slstm)
        return XLstmCache(zeros(n, *hs), zeros(n, *ns), *slstm)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                image_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None):
        """tokens ``[B, S]`` -> (last-position logits ``[B, 1, V]`` f32, a
        new cache holding the prompt: ``cache_len`` (default S) positions of
        keys and values, or the recurrent state after the prompt; for
        ``dec`` also the cross keys and values of the encoder's output over
        ``encoder_frames`` ``[B, encoder_seq, D]``). ``image_embeds`` ``[B,
        n_image_embeds, D]`` are the VLM's front-end input."""
        x = self._embed_inputs(tokens, image_embeds)
        b, s, _ = x.shape
        cache = self.init_cache(b, cache_len or s)
        x, _ = self._run(x, torch.arange(s, device=x.device), cache, 0,
                         self._memory(encoder_frames))
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache,
                    pos: Union[int, torch.Tensor]):
        """tokens ``[B, 1]`` at position ``pos`` (the KV cache's write
        offset) -> (logits ``[B, 1, V]`` f32, the same cache, written in
        place). ``pos`` is the batch's one position (an int) or each
        sequence's own (a ``[B]`` int64 tensor on the model's device), which
        RoPE, the cache write and the attention mask then read per row.
        Tokens only: the image embeds and the encoder's memory entered at
        the prefill (the cross keys and values are read from the cache)."""
        x = self._embed(tokens)
        if torch.is_tensor(pos):  # each attention stage's indices and mask (_run)
            positions = pos[:, None]
        else:
            positions = torch.arange(pos, pos + 1, device=x.device)
            pos = int(pos)
        x, _ = self._run(x, positions, cache, pos)
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
