"""Hopper kernels of the port (CUDA C++ under ``csrc/``), their plain
PyTorch versions (``ref``) and the device dispatch (``ops``)."""
