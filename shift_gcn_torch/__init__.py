"""PyTorch/CUDA port of the Shift-GCN fall-detection serving path.

Entry points: ``inference.pipeline.EnsemblePredictor`` /
``run_on_landmarks`` and ``models.shift_gcn.Model``.  They run on CUDA by
default (hand-written kernels in ``csrc/``) and on the CPU, through the
kernels' plain PyTorch versions, only when the caller passes
``device="cpu"``.
"""
