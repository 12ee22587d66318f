"""Training on PyTorch: the optimizers (``optimizer.py``), checkpoints
with async writes and the RL policy checkpoints (``checkpoint.py``), the LM
train and eval steps (``train_step.py``), gradient compression
(``compression.py``) and the straggler watchdog (``stragglers.py``)."""
