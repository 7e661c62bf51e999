"""Hand-written Hopper kernels (``csrc/``), their ctypes bindings and
their plain PyTorch twins (``ref``)."""
