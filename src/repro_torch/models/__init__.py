"""The LM substrate on PyTorch: the dense family (``internlm2-1.8b``,
``glm4-9b``, ``stablelm-3b``, ``qwen3-14b``), the Mamba-2 hybrid
(``zamba2-2.7b``) and xLSTM (``xlstm-350m``).

``build_model(arch_config, device)`` returns a :class:`Transformer`
(``nn.Module``) with ``init``, ``forward``, ``prefill``, ``decode_step``,
``init_cache`` and ``n_params``; ``convert.params_from_arrays`` loads the
reference's parameter pytree into it.
"""
from repro_torch.models.transformer import (
    KVCache, Transformer, XLstmCache, ZambaCache, build_model,
)

__all__ = ["KVCache", "Transformer", "XLstmCache", "ZambaCache", "build_model"]
