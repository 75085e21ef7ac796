"""Hand-written Hopper kernels of the port, their plain versions and wrappers.

``ops`` holds the public wrappers, ``ref`` the plain PyTorch versions,
``_build`` builds the CUDA sources under ``csrc/`` at first use.
"""
