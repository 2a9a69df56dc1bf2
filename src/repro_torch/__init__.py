"""PyTorch/CUDA port of the SwapNet reproduction (the JAX package
``repro`` is the reference). It imports torch and numpy, never JAX."""
