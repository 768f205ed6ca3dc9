"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch versions. Importing this package builds nothing."""
