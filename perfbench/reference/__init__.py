"""Plain PyTorch references that decide ``correct``: float32 with TF32
off, computed in blocks (a layer, a row) beside nothing of the program.
They import neither ``jax``, ``repro`` nor ``repro_torch``: the weights
are drawn again from the seed (``harness.weights``) and the inputs are
the ones the benchmark made."""
