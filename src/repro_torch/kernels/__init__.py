"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
the host quantizers and the quantized-resident tensor."""
