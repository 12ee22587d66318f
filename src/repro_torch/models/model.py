"""Public model API: ``build_model(config, device) -> Transformer`` (the
reference's ``models/model.py``; see :mod:`repro_torch.models.transformer`)."""
from repro_torch.models.transformer import Transformer, build_model  # noqa: F401
