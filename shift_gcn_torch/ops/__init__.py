"""Eval-path ops: batch norm, convs, the spatial and temporal shifts and
their CUDA kernel wrappers."""
