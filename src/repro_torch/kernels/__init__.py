"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and the ``ops`` entry
points that pick between them by the tensors' device."""
