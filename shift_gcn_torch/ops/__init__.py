"""Ops: batch norm, convs, the spatial and temporal shifts, and their CUDA
kernel wrappers with their autograd Functions.  Importing the package
registers the forward kernels as torch operators (``library``)."""

from shift_gcn_torch.ops import library  # noqa: F401
