"""Tensor ops of the port: plain PyTorch functions plus the CUDA kernels'
wrappers (``*_cuda.py``)."""
