"""Smoke demo of the port's learnable fractional temporal-shift op.

The counterpart of ``scripts/demo_shift_op.py`` (the reference's
CUDA-extension demo, model/Temporal_shift/demo.py:13-29 + run.sh): run
forward and backward on a tiny ones tensor and print outputs and
gradients, including the constraint backward's ypos steps (±0.01 by the
sign of the raw position gradient, the 1e-4 tie step where it is
exactly 0, reference shift_cuda_kernel.cu:370-395) and the zeroed xpos
gradient.  On a CUDA device the forward launches K1 and the backward the
fused K2+K3 kernel; ``--torch-device cpu`` runs their plain versions.

Usage: python scripts/torch_demo_shift_op.py [--stride 1]
    [--torch-device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from shift_gcn_torch.ops.temporal_shift import temporal_shift  # noqa: E402
from shift_gcn_torch.utils.device import resolve_device  # noqa: E402


def run_demo(stride: int = 1, device="cuda") -> Dict[str, torch.Tensor]:
    """Forward and ``sum(out ** 2)`` backward of ``temporal_shift`` on
    ones(1, 8, 4, 5), channels-last (N, T, V, C; the reference's
    ones(1, 5, 8, 4) in N, C, H=T, W=V), xpos zeros and ypos
    linspace(-1, 1, 5).  Returns out, grad_input, grad_xpos and grad_ypos
    on ``device``; raises if ``device`` is CUDA and no GPU is present."""
    dev = resolve_device(device)
    n, t, v, c = 1, 8, 4, 5
    x = torch.ones((n, t, v, c), dtype=torch.float32, device=dev,
                   requires_grad=True)
    xpos = torch.zeros(c, dtype=torch.float32, device=dev,
                       requires_grad=True)
    ypos = torch.tensor(np.linspace(-1.0, 1.0, c), dtype=torch.float32,
                        device=dev, requires_grad=True)
    out = temporal_shift(x, ypos, stride, xpos=xpos)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "grad_input": x.grad,
            "grad_xpos": xpos.grad, "grad_ypos": ypos.grad}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stride", type=int, default=1, choices=(1, 2))
    parser.add_argument("--torch-device", default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args()

    r = run_demo(args.stride, args.torch_device)
    out = r["out"]
    print(f"device: {out.device}")
    print(f"forward out shape: {tuple(out.shape)}")
    print("out[0, :, 0, :] =")
    print(out[0, :, 0, :].cpu().numpy())
    print(f"grad_input norm: "
          f"{float(torch.linalg.vector_norm(r['grad_input'])):.4f}")
    print(f"grad_xpos (always zero): {r['grad_xpos'].cpu().numpy()}")
    print(f"grad_ypos (±0.01 steps, 1e-4 where the raw gradient is "
          f"exactly 0): {r['grad_ypos'].cpu().numpy()}")


if __name__ == "__main__":
    main()
