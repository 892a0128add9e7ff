"""The plain reference the benchmark judges the port by.

Plain PyTorch and NumPy in float32 (TF32 off), written from the Shift-GCN
paper's layer equations and the source repository's semantics.  It
imports nothing of the port and nothing of JAX, and takes only what the
benchmark made: weights, clips and tracks.  ``precision`` selects the
lower precision of a control run (``tf32``: matmul and conv operands
rounded to TF32; ``fp8``: activations and their gradients rounded to
scaled fp8).
"""
