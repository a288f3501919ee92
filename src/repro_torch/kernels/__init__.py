"""Hand-written CUDA kernels for Hopper (csrc/) with their plain PyTorch
versions (ref.py) and dispatching wrappers (ops.py)."""
