"""Ops: batch norm, convs, the spatial and temporal shifts, and their CUDA
kernel wrappers with their autograd Functions."""
