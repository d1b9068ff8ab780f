"""Ops of the port: layers, attention, and the CUDA kernels' wrappers."""
