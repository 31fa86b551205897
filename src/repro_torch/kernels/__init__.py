"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain torch
versions (:mod:`.ref`) and the device decode around them (:mod:`.ops`)."""
