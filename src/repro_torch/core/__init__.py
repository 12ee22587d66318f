"""Engine, policy rules, metrics and the sequential oracle (``core/ref``)."""
