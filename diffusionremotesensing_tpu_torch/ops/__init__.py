"""Tensor ops of the port: layout transforms, resizing and the hand-written
CUDA kernels with their plain PyTorch versions."""
