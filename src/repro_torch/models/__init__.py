"""The LM substrate on PyTorch: every architecture the reference registers —
the dense family (``internlm2-1.8b``, ``glm4-9b``, ``stablelm-3b``,
``qwen3-14b``, ``internvl2-26b`` with its image embeds), the MoE family
(``qwen2-moe-a2.7b``, ``grok-1-314b``), the Mamba-2 hybrid
(``zamba2-2.7b``), xLSTM (``xlstm-350m``) and the encoder-decoder
``whisper-tiny``.

Block programs that mix block types (``ArchConfig.stages``) and
standalone ``mamba2``, ``mlstm``, ``slstm`` and ``enc`` stages run too.
``build_model(config, device)`` returns a :class:`Transformer`
(``nn.Module``) with ``init``, ``forward``, ``loss``, ``prefill``,
``decode_step``, ``init_cache`` and ``n_params``;
``convert.params_from_arrays`` loads the reference's parameter pytree into
it, ``convert.params_to_arrays`` gives it back, and
``convert.reference_leaves`` describes the reference's leaves over its
tensors (what training's optimizer runs on).
"""
from repro_torch.models.transformer import (
    EncDecCache, KVCache, Mamba2Cache, MLstmCache, SLstmCache, Transformer, XLstmCache,
    ZambaCache, build_model,
)

__all__ = ["EncDecCache", "KVCache", "Mamba2Cache", "MLstmCache", "SLstmCache", "Transformer",
           "XLstmCache", "ZambaCache", "build_model"]
