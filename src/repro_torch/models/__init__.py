"""The LM substrate on PyTorch: the dense family (``internlm2-1.8b``) and
xLSTM (``xlstm-350m``).

``build_model(arch_config, device)`` returns a :class:`Transformer`
(``nn.Module``) with ``init``, ``forward``, ``prefill``, ``decode_step``,
``init_cache`` and ``n_params``; ``convert.params_from_arrays`` loads the
reference's parameter pytree into it.
"""
from repro_torch.models.transformer import KVCache, Transformer, XLstmCache, build_model

__all__ = ["KVCache", "Transformer", "XLstmCache", "build_model"]
