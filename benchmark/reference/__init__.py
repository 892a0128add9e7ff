"""The plain reference the benchmark judges the port by.

Plain PyTorch and NumPy in float32 (TF32 off).  The model is the
configuration's family's (``families/<family>.py`` ``forward``, written
from its paper's layer equations and its source repository's
semantics); here are what every family shares (``model.py``), the
training step (``train.py``) and Shift-GCN's fall report (``serve.py``).
It imports nothing of the port and nothing of JAX, and takes only what
the benchmark made: weights, clips and tracks.  ``precision`` selects the
lower precision of a control run (``tf32``: matmul and conv operands
rounded to TF32; ``fp8``: activations and their gradients rounded to
scaled fp8).
"""
