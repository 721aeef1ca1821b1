"""PyTorch/CUDA port of the AQUA serving system (see ``repro`` for the JAX
reference it is held against)."""
