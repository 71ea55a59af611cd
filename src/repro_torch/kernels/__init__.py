"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers,
their plain PyTorch versions (``ref``) and the dispatching entry points
(``ops``). Nothing here builds or loads a kernel at import time."""
