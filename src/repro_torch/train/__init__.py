"""Training: optimizers, int8 error-feedback compression and the train
step (port of ``repro/train``)."""
