"""Training utilities of the PyTorch port: the RL learners' optimizer and
policy checkpoints (``optimizer.py``, ``checkpoint.py``). The LM training
stack is ROADMAP Queue 1 item 12c."""
