"""Training: the optimizers, the train step and the ``Trainer`` (port of
``repro/training``)."""
