"""Hand-written Hopper kernels of the port, one family per directory:
``csrc/`` CUDA sources, ``kernel.py`` build and binding, ``ref.py`` the
plain PyTorch version, ``ops.py`` the public op."""
