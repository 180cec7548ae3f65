"""Tensor ops of the port: plain PyTorch versions and the dispatchers that
send CUDA tensors to the hand-written kernels (`ops/kernels`)."""
