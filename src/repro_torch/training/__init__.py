"""Training on PyTorch: the optimizers (``optimizer.py``), checkpoints
with async writes and the RL policy checkpoints (``checkpoint.py``), the LM
train and eval steps (``train_step.py``), gradient compression
(``compression.py``), the straggler watchdog (``stragglers.py``), GPipe
over worker processes (``pipeline.py``) and elastic resharding onto a
smaller or larger worker set (``elastic.py``).

The optimizer names are the reference's ``repro.training`` exports."""
from repro_torch.training.optimizer import (
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    sgd,
)

__all__ = [
    "OptState",
    "adamw",
    "adafactor",
    "sgd",
    "clip_by_global_norm",
    "cosine_schedule",
]
