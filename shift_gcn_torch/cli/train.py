"""Train a Shift-GCN model with the port.

    python -m shift_gcn_torch.cli.train --config <yaml> [--key value ...]
        [--torch-device cpu]
    torchrun --nproc-per-node N -m shift_gcn_torch.cli.train --config <yaml>

``--key value`` overrides any config key (CLI > YAML > defaults).  The
run goes to the GPU; ``--torch-device cpu`` runs the kernels' plain
PyTorch versions on the CPU instead.  (The config key ``device`` keeps
its reference meaning, a list of GPU ids, and is not read.)

Under a multi-process launcher (torchrun, SLURM, Open MPI;
``parallel/launch.py``, ``SGT_DISTRIBUTED=1/0`` overrides) each process
joins the default process group on its own card, ``cuda:<local rank>``
(NCCL; gloo with ``--torch-device cpu``), and the Trainer runs the
config's ``mesh_shape`` over the ranks.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch.distributed as dist

from shift_gcn_torch.parallel import launch
from shift_gcn_torch.train.config import load_config
from shift_gcn_torch.train.trainer import Trainer


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to train on (default cuda)")
    known, rest = ap.parse_known_args(argv)
    cfg = load_config(rest)
    device = known.torch_device
    created = False
    if launch.should_init_distributed():
        created = not dist.is_initialized()
        device = launch.init_distributed(device)
    try:
        return Trainer(cfg, device=device).start()
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
